"""Port parity of ``parallel/``, on the CPU: the decoder's tensor-parallel
shards against the JAX ``llama_param_spec``; a model=2 and a model=4
decoder (W8A8 prefill, decode over the int8 cache) on gloo ranks against
one process and against JAX ``llama_apply``; data-parallel certification
(serial and continuous, sigma 0.5) and finetuning on two ranks against one
process; and the port's ``dryrun_multichip(8)`` against one process and
against the JAX package's cases on the suite's 8 virtual devices.

Every multi-rank run joins its gloo group through a file under
``tmp_path`` (``parallel/processes.py``: no TCP port), one thread a rank,
each rank waited for with a timeout."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_finetune import train_set  # noqa: F401
from test_torch_launch import vqa  # noqa: F401
from test_torch_train_model import _batch as _train_batch

from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit
from certifiedgpt_tpu.ops.quantization import quantize_llama as j_quantize_llama
from certifiedgpt_tpu.parallel import mesh as JMESH
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.parallel import mesh as TMESH
from certifiedgpt_tpu_torch.parallel.dryrun import dryrun_cases, dryrun_inputs, dryrun_multichip
from certifiedgpt_tpu_torch.parallel.processes import run_ranks

#: the decoder's serving tolerance of tests/test_torch_llama.py: the int8
#: activation and cache rounds can flip one step where the f32 products
#: differ in the last ulp
SERVING_TOL = 5e-3
#: losses of two runs that differ only in f32 summation order
LOSS_RTOL = 1e-5
TIMING_KEYS = {"seconds", "mean_seconds_per_image", "elapsed_seconds", "images_per_hour"}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tree_paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _tree_paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _serving_llama_params(cfg_j):
    params = JLM.init_llama(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a)).astype(np.float32), params)
    return jax.tree.map(np.asarray, j_quantize_llama(jax.tree.map(jnp.asarray, params)))


@pytest.mark.parametrize("n_model", [2, 4])
def test_partition_llama_matches_jax_specs(n_model):
    """Every leaf of the serving decoder: the port's spec is the JAX
    ``llama_param_spec`` (top-level leaves: the JAX ``partition_llama``'s
    vocabulary specs), each rank's shard is the spec's block, and the
    blocks of the model group put the leaf back together exactly."""
    cfg_j = JLM.LlamaConfig.tiny(act_quant=True, kv_quant=True, num_kv_heads=4)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _serving_llama_params(cfg_j))
    tree["lm_head"]["bias"] = torch.zeros(cfg_j.vocab_size)
    top_specs = {("lm_head", "kernel"): (None, "model"), ("lm_head", "bias"): (),
                 ("embed_tokens", "embedding"): ("model", None)}
    shards = [TMESH.partition_llama(tree, TMESH.ProcessMesh(1, 1, n_model, rank), cfg_j)
              for rank in range(n_model)]
    for path, full in _tree_paths(tree):
        if path[0] == "layers":
            spec = TMESH.llama_param_spec(path[1], path[2])
            assert spec == tuple(JMESH.llama_param_spec(path[1], path[2])), path
        else:
            spec = top_specs.get(path, ())
        parts = []
        for shard in shards:
            leaf = shard
            for key in path:
                leaf = leaf[key]
            parts.append(leaf)
        if "model" in spec:
            dim = spec.index("model")
            assert all(p.shape[dim] * n_model == full.shape[dim] for p in parts), path
            assert torch.equal(torch.cat(parts, dim=dim), full), path
        else:
            assert all(p is full for p in parts), path


_TP_WORKER = """
import numpy as np, torch
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.parallel.mesh import make_mesh, partition_llama, set_active_mesh
data = torch.load("inputs.pt")
cfg = TLM.LlamaConfig.tiny(act_quant=True, kv_quant=True, num_kv_heads=4)

def run(params):
    b, s = data["x"].shape[:2]
    new = data["new"]
    cache = TLM.init_kv_cache(cfg, b, s + new, "cpu")
    logits, _, cache = TLM.llama_apply(params, cfg, data["x"], data["cache_mask"],
                                       data["positions"], cache, 0)
    out, tokens = [logits[:, -1]], []
    pos = data["next_pos"]
    for t in range(new):
        token = torch.argmax(out[-1], dim=-1)
        tokens.append(token)
        emb = TLM.embed_tokens(params, token[:, None])
        logits, _, cache = TLM.llama_apply(params, cfg, emb, data["cache_mask"],
                                           pos[:, None], cache, s + t)
        out.append(logits[:, -1])
        pos = pos + 1
    return torch.stack(out), torch.stack(tokens)

outputs = {}
with torch.no_grad():
    outputs["one"] = run(data["params"])
    # model=4 over the four ranks, then model=2 (two data replicas)
    for n_model in (4, 2):
        mesh = make_mesh(n_model=n_model)
        set_active_mesh(mesh)
        outputs[n_model] = run(partition_llama(data["params"], mesh, cfg))
        set_active_mesh(None)
if RANK == 0:
    torch.save(outputs, "outputs.pt")
"""


@pytest.fixture(scope="module")
def tensor_parallel_runs(tmp_path_factory):
    """The serving decoder's W8A8 prefill of a left-padded prompt and three
    greedy steps over the int8 cache: in one process, split over 4 gloo
    ranks (model=4) and over 2 (model=2, data=2) in one 4-rank job; and the
    same in JAX ``llama_apply``."""
    tmp_path = tmp_path_factory.mktemp("tp")
    kw = dict(act_quant=True, kv_quant=True, num_kv_heads=4)
    cfg_j = JLM.LlamaConfig.tiny(**kw)
    params = _serving_llama_params(cfg_j)
    b, s, new = 3, 6, 3
    mask = np.ones((b, s), np.int32)
    mask[1, :2] = 0  # left padding
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    cache_mask = np.concatenate([mask, np.ones((b, new), np.int32)], 1)
    x = np.random.RandomState(2).randn(b, s, cfg_j.hidden_size).astype(np.float32)
    torch.save({"params": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params),
                "x": torch.from_numpy(x), "cache_mask": torch.from_numpy(cache_mask),
                "positions": torch.from_numpy(positions).long(),
                "next_pos": torch.from_numpy(mask.sum(1)).long(), "new": new},
               tmp_path / "inputs.pt")
    run_ranks(4, _TP_WORKER, str(tmp_path), timeout=240)
    got = torch.load(tmp_path / "outputs.pt")

    jparams = jax.tree.map(jnp.asarray, params)
    jcache = JLM.init_kv_cache(cfg_j, b, s + new)
    jl, _, jcache = JLM.llama_apply(jparams, cfg_j, jnp.asarray(x), jnp.asarray(cache_mask),
                                    jnp.asarray(positions), kv_cache=jcache,
                                    cache_offset=jnp.int32(0))
    want_logits, want_tokens = [np.asarray(jl[:, -1])], []
    pos = jnp.asarray(mask.sum(1))
    for t in range(new):
        token = jnp.argmax(jnp.asarray(want_logits[-1]), -1)
        want_tokens.append(np.asarray(token))
        emb = JLM.embed_tokens(jparams, token[:, None])
        jl, _, jcache = JLM.llama_apply(jparams, cfg_j, emb, jnp.asarray(cache_mask),
                                        pos[:, None], kv_cache=jcache,
                                        cache_offset=jnp.int32(s + t))
        want_logits.append(np.asarray(jl[:, -1]))
        pos = pos + 1
    got["jax"] = (np.stack(want_logits), np.stack(want_tokens))
    return got


@pytest.mark.parametrize("n_model", [2, 4])
def test_tensor_parallel_decoder_matches_one_process_and_jax(tensor_parallel_runs, n_model):
    """The decoder split over ``n_model`` gloo ranks: greedy tokens equal to
    one process's and to JAX ``llama_apply``'s, the logits of the prefill
    and of every step within the serving tolerance of both."""
    tp_logits, tp_tokens = tensor_parallel_runs[n_model]
    one_logits, one_tokens = tensor_parallel_runs["one"]
    want_logits, want_tokens = tensor_parallel_runs["jax"]
    assert torch.equal(tp_tokens, one_tokens)
    np.testing.assert_array_equal(tp_tokens.numpy(), want_tokens)
    for step in range(len(want_logits)):
        assert _rel(tp_logits[step].numpy(), one_logits[step].numpy()) < SERVING_TOL
        assert _rel(tp_logits[step].numpy(), want_logits[step]) < SERVING_TOL


_TP_TRAIN_WORKER = """
import pickle, torch
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.parallel.mesh import make_mesh, set_active_mesh, shard_decoder
data = pickle.load(open("inputs.pkl", "rb"))
batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
         for k, v in data["batch"].items()}
mesh = make_mesh(n_model=WORLD_SIZE)
outputs = {}
for name, (w8a8, params) in data["models"].items():
    vit = dict(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla")
    cfg = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                 llama=TLM.LlamaConfig.tiny(act_quant=w8a8))
    model = MiniGPT4Model(cfg, params_from_jax(params, cfg, "cpu"), None)
    set_active_mesh(mesh)
    shard_decoder(model, mesh)
    trainable = model.make_trainable(("llama_proj",))
    loss = TM.minigpt4_loss(model.params, cfg, batch)
    loss.backward()
    set_active_mesh(None)
    outputs[name] = (float(loss), {k: v.grad.clone() for k, v in trainable["llama_proj"].items()})
if RANK == 0:
    torch.save(outputs, "outputs.pt")
"""

#: the two int8 decoders of the shipped training configs: ``w8a8`` (the
#: towers and the decoder W8A8, as ``_w8a8.yaml``) and ``int8_weight`` (a
#: float ViT, the decoder's kernels int8 with float activations)
QUANTIZED_DECODERS = {"w8a8": True, "int8_weight": False}


def _quantized_models(w8a8: bool):
    cj = JM.MiniGPT4Config.tiny(
        vit=JV.EvaViTConfig.tiny(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla"),
        llama=JLM.LlamaConfig.tiny(act_quant=w8a8))
    params = JM.init_minigpt4(jax.random.PRNGKey(0), cj)
    if w8a8:
        params["vit"] = quantize_eva_vit(params["vit"])
    params["llama"] = j_quantize_llama(params["llama"])
    return cj, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tensor_parallel_train_runs(tmp_path_factory):
    """The MiniGPT-4 loss and its ``llama_proj`` gradient on the two int8
    decoders (``QUANTIZED_DECODERS``) of one seeded batch: split over two
    gloo ranks (model=2) in one job, in one process, and ``jax.value_and_grad``
    of the JAX loss."""
    import pickle

    tmp_path = tmp_path_factory.mktemp("tp-train")
    models = {name: _quantized_models(w8a8) for name, w8a8 in QUANTIZED_DECODERS.items()}
    batch = _train_batch(models["w8a8"][0], pack=1)
    with open(tmp_path / "inputs.pkl", "wb") as handle:
        pickle.dump({"batch": batch, "models": {name: (QUANTIZED_DECODERS[name], params)
                                                for name, (_, params) in models.items()}},
                    handle)
    run_ranks(2, _TP_TRAIN_WORKER, str(tmp_path), timeout=240)
    got = {name: {"tp": value} for name, value in torch.load(tmp_path / "outputs.pt").items()}
    tbatch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
              for k, v in batch.items()}
    for name, (cj, params) in models.items():
        w8a8 = QUANTIZED_DECODERS[name]
        vit = dict(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla")
        ct = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                    llama=TLM.LlamaConfig.tiny(act_quant=w8a8))
        model = MiniGPT4Model(ct, params_from_jax(params, ct, "cpu"), None)
        trainable = model.make_trainable(("llama_proj",))
        loss = TM.minigpt4_loss(model.params, ct, tbatch)
        loss.backward()
        got[name]["one"] = (float(loss.detach()), {k: v.grad for k, v in trainable["llama_proj"].items()})
        jtrain, frozen = JM.split_params(jax.tree.map(jnp.asarray, params))
        jval, jgrad = jax.value_and_grad(lambda tr: JM.minigpt4_loss(
            JM.merge_params(tr, frozen), cj, {k: jnp.asarray(v) for k, v in batch.items()}))(
                jtrain)
        got[name]["jax"] = (float(jval), {k: np.asarray(v)
                                          for k, v in jgrad["llama_proj"].items()})
    return got


@pytest.mark.parametrize("decoder", list(QUANTIZED_DECODERS))
def test_tensor_parallel_quantized_backward_matches_one_process_and_jax(
        tensor_parallel_train_runs, decoder):
    """The training forward and backward of a model=2 int8 decoder (W8A8:
    the row-split input quantized after the MAX over the model group, the
    straight-through ``_grad_input``; weight-only: ``int8_weight_grad``;
    both through the model-group sum of ``copy_to_model``'s backward):
    the loss within ``LOSS_RTOL`` of one process's and the ``llama_proj``
    gradient within 1e-5 relative of it (only the f32 summation order of
    the gradient's sum over the ranks differs: measured ~1e-6; without that
    sum the gradient is 0.9 off); against ``jax.value_and_grad``
    the train tolerances of tests/test_torch_train_model.py: the loss within
    2e-3 (W8A8) or 1e-5 (weight-only) relative, the gradient within 2e-2 or
    1e-4."""
    runs = tensor_parallel_train_runs[decoder]
    (tp_loss, tp_grad), (one_loss, one_grad) = runs["tp"], runs["one"]
    jax_loss, jax_grad = runs["jax"]
    np.testing.assert_allclose(tp_loss, one_loss, rtol=LOSS_RTOL)
    loss_tol, grad_tol = (2e-3, 2e-2) if QUANTIZED_DECODERS[decoder] else (1e-5, 1e-4)
    assert abs(tp_loss - jax_loss) / abs(jax_loss) < loss_tol
    for key in ("kernel", "bias"):
        assert _rel(tp_grad[key].numpy(), one_grad[key].numpy()) < 1e-5, key
        assert _rel(tp_grad[key].numpy(), jax_grad[key]) < grad_tol, key


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
            for line in open(path).read().splitlines()]


@pytest.fixture(scope="module")
def data_parallel_certify(vqa, tmp_path_factory):  # noqa: F811
    """The serial and the continuous certify configs at sigma 0.5 with
    ``run.distributed`` on two gloo ranks (data=2), one 2-rank job; rank
    1 writes into its own output directory. Returns the output root and the
    configs by mode."""
    tmp_path = tmp_path_factory.mktemp("dp-certify")
    cfgs = {}
    for continuous in (False, True):
        cfg = vqa("image_text_certify", f"dp-certify-{continuous}", distributed=True,
                  noise_level=0.5, continuous=continuous, active_images=2)
        (tmp_path / f"certify-{continuous}.yaml").write_text(json.dumps(cfg))  # JSON is YAML
        cfgs[continuous] = cfg
    run_ranks(2, f"""
import json
from certifiedgpt_tpu_torch import launch
for mode in ("False", "True"):
    cfg = json.load(open(f"{{{str(tmp_path)!r}}}/certify-{{mode}}.yaml"))
    if RANK:
        cfg["run"]["output_dir"] += "-rank1"
    json.dump(cfg, open(f"rank{{RANK}}-{{mode}}.yaml", "w"))
    launch.main(["certify", "--config-path", f"rank{{RANK}}-{{mode}}.yaml", "--device", "cpu"])
""", str(tmp_path), timeout=240)
    return vqa.root / "out", cfgs


@pytest.mark.parametrize("continuous", [False, True], ids=["serial", "continuous"])
def test_data_parallel_certify_equals_one_process(data_parallel_certify, continuous):
    """``run.distributed`` on two gloo ranks (data=2) at sigma 0.5: each
    rank draws the whole noise tile and keeps its rows, the tokens are
    gathered, so labels, radii and draws equal one process's exactly; only
    rank 0 writes the rows."""
    root, cfgs = data_parallel_certify
    cfg, out = cfgs[continuous], f"dp-certify-{continuous}"
    assert not (root / f"{out}-rank1" / "certify_results.jsonl").exists()
    one = dict(cfg["run"], distributed=False, output_dir=str(root / f"{out}-one"))
    agent = setup_agent(Config(dict(cfg, run=one)), device="cpu")
    try:
        agent.run()
    finally:
        agent.finalize()
    got = _rows(root / out / "certify_results.jsonl")
    want = _rows(root / f"{out}-one" / "certify_results.jsonl")
    assert got == want and len(got) == 2
    assert all(r["draws"] > 0 for r in got)


def test_data_parallel_finetune_agent_end_to_end(train_set, tmp_path):  # noqa: F811
    """The finetune agent on two gloo ranks (data=2: 8 rows a rank, packed
    2 to a row, noise 0.5, a partial val batch wrapped across the ranks)
    over two epochs: both ranks log the one-process losses (within
    ``LOSS_RTOL``), rank 0's checkpoint holds one process's ``llama_proj``
    (within ``LOSS_RTOL``), and rank 1 writes no checkpoint, history or
    metrics file."""
    cfg = train_set("dp", noise_level=0.5)
    path = tmp_path / "train.yaml"
    path.write_text(json.dumps(cfg))
    run_ranks(2, f"""
import json
from certifiedgpt_tpu_torch import launch
cfg = json.load(open({str(path)!r}))
cfg["run"].update(distributed=True, output_dir=cfg["run"]["output_dir"] + f"-rank{{RANK}}")
json.dump(cfg, open(f"rank{{RANK}}.yaml", "w"))
res = launch.main(["train", "--config-path", f"rank{{RANK}}.yaml", "--device", "cpu"])
json.dump(res, open(f"result{{RANK}}.json", "w"))
""", str(tmp_path), timeout=300)
    agent = setup_agent(Config(cfg), device="cpu")
    try:
        want = agent.run()
    finally:
        agent.finalize()
    root = train_set.root / "out"
    want_hist = json.load(open(root / "dp" / "loss_history.json"))
    got_hist = json.load(open(root / "dp-rank0" / "loss_history.json"))
    for split in ("train", "val"):
        assert len(got_hist[split]) == 2
        np.testing.assert_allclose(got_hist[split], want_hist[split], rtol=LOSS_RTOL)
    for rank in (0, 1):
        res = json.load(open(tmp_path / f"result{rank}.json"))
        assert res["epochs"] == want["epochs"] and res["steps"] == want["steps"]
        np.testing.assert_allclose(res["best_val"], want["best_val"], rtol=LOSS_RTOL)
    with np.load(root / "dp-rank0" / "vqa.npz") as got, np.load(root / "dp" / "vqa.npz") as ref:
        assert set(got.files) == set(ref.files)
        for key in ref.files:
            np.testing.assert_allclose(got[key], ref[key], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=key)
    rank1 = root / "dp-rank1"
    for name in ("vqa.npz", "vqa_best.npz", "loss_history.json", "vqa.txt"):
        assert not (rank1 / name).exists(), name


def _jax_dryrun_losses(inputs, n_devices):
    """The JAX dry run's two train-step losses on the suite's virtual
    devices (data x model mesh, the decoder partitioned, the batch split
    over data) from the port's seeded parameters, batches and noise."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from certifiedgpt_tpu.models.minigpt4 import (
        MiniGPT4Config,
        merge_params,
        minigpt4_loss,
        split_params,
    )
    from certifiedgpt_tpu.optim import make_optimizer

    cfg = MiniGPT4Config.tiny()
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = JMESH.make_mesh(n_data=n_devices // n_model, n_model=n_model,
                           devices=jax.devices()[:n_devices])
    params = jax.tree.map(jnp.asarray, inputs["params"])
    params["llama"] = JMESH.partition_llama(params["llama"], mesh)
    trainable, frozen = split_params(params)
    optimizer = make_optimizer(lambda step: 1e-4)
    opt_state = optimizer.init(trainable)

    def shard(batch, noise):
        out = {k: jnp.asarray(v) for k, v in batch.items()}
        out["image"] = out["image"] + jnp.asarray(noise)
        return {k: jax.device_put(v, NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))))
                for k, v in out.items()}

    @jax.jit
    def step(trainable, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda tr: minigpt4_loss(merge_params(tr, frozen), cfg, batch))(trainable)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return optax.apply_updates(trainable, updates), opt_state, loss

    with mesh:
        trainable, opt_state, loss = step(trainable, opt_state,
                                          shard(inputs["batch"], inputs["noise"]))
        _, _, loss_p = step(trainable, opt_state, shard(inputs["packed"], inputs["packed_noise"]))
        return float(loss), float(loss_p)


def _jax_dryrun_pipeline(inputs, n_devices):
    """The JAX dry run's fifth case on the port's seeded parameters and
    train batch: the loss and the ``llama_proj`` gradient's global norm of
    ``pipeline_minigpt4_loss`` on a pipe=2 x data mesh at 2 microbatches."""
    from certifiedgpt_tpu.models.minigpt4 import MiniGPT4Config, merge_params, split_params
    from certifiedgpt_tpu.parallel.pipeline import (
        partition_llama_pipeline,
        pipeline_minigpt4_loss,
    )

    cfg = MiniGPT4Config.tiny()
    mesh = JMESH.make_mesh(n_pipe=2, devices=jax.devices()[:n_devices])
    params = jax.tree.map(jnp.asarray, inputs["params"])
    params["llama"] = partition_llama_pipeline(params["llama"], mesh)
    trainable, frozen = split_params(params)
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    with mesh:
        loss, grads = jax.value_and_grad(lambda tr: pipeline_minigpt4_loss(
            merge_params(tr, frozen), cfg, batch, mesh, n_micro=2))(trainable)
    norm = float(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)) ** 0.5)
    return float(loss), norm


def test_dryrun_multichip_eight_processes(tmp_path, capsys):
    """``dryrun_multichip(8)``: the five cases on 8 gloo ranks print the JAX
    dry run's line, the pipeline case's included; labels equal one
    process's exactly, losses within ``LOSS_RTOL`` of one process's, and
    the train-step losses within the decoder's float tolerance of
    tests/test_torch_train_model.py (1e-5 relative) of the JAX package's on
    the same parameters, batches and noise; the pipeline case's loss within
    ``LOSS_RTOL`` of the one-process (sequential) loss and within 1e-5 of
    the JAX dry run's fifth case, its ``llama_proj`` gradient norm within
    1e-4 of both."""
    got = dryrun_multichip(8, workdir=str(tmp_path))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: 8 processes (data=4 x model=2)")
    assert "dcn-certify label=" in line
    assert line.endswith(f", pipeline-train loss={got['pipe_loss']:.4f} (pipe=2 x data=4)")
    one = dryrun_cases(8, distributed=False)
    for key in ("certify_label", "dcn_certify_label", "n_data", "n_model", "dcn_data",
                "pipe_data"):
        assert got[key] == one[key], key
    for key in ("loss", "packed_loss", "dcn_loss", "pipe_loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=LOSS_RTOL, err_msg=key)
    inputs = dryrun_inputs(8)
    jax_loss, jax_packed = _jax_dryrun_losses(inputs, 8)
    np.testing.assert_allclose(one["loss"], jax_loss, rtol=1e-5)
    np.testing.assert_allclose(one["packed_loss"], jax_packed, rtol=1e-5)
    np.testing.assert_allclose(got["dcn_loss"], jax_loss, rtol=1e-5)
    jax_pipe, jax_norm = _jax_dryrun_pipeline(inputs, 8)
    np.testing.assert_allclose(got["pipe_loss"], jax_pipe, rtol=1e-5)
    np.testing.assert_allclose(got["pipe_grad_norm"], jax_norm, rtol=1e-4)
    np.testing.assert_allclose(got["pipe_grad_norm"], one["pipe_grad_norm"], rtol=1e-4)
