"""Port parity of ``parallel/pipeline.py``, the GPipe decoder, on gloo ranks.

One 4-rank job (``parallel/processes.py``) feeds the module's fixture: the
4-layer fp32 tiny decoder's pipelined forward at (pipe, n_micro) = (2, 4),
(4, 2) and (2, 1) (pipe=2 runs on pipe=2 x data=2) against JAX
``pipeline_llama_apply`` and ``llama_apply``; the MiniGPT-4 loss and its
gradients through the hand-written reverse schedule, packed and unpacked, on
pipe=2 x data=2 at 2 microbatches, against ``jax.value_and_grad`` of the
JAX pipeline loss and the port's one-process loss; the same for a W8A8 and
a weight-only int8 decoder against one process. Every rank reports its own
results, so a gradient missing on a stage, or summed over the stages, fails.
2-rank jobs run the finetune agent and the eval agent with
``pipeline_parallel: 2`` through ``launch.main`` against one process (the
certify agent's rows under the knob:
``tests/test_torch_launch.py::test_unported_knobs_are_refused``).
The refusals raise the JAX package's messages."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pipeline_parallel import _mgpt_batches, _pipe_mesh
from test_torch_finetune import train_set  # noqa: F401
from test_torch_launch import vqa  # noqa: F401
from test_torch_parallel import LOSS_RTOL, QUANTIZED_DECODERS, _quantized_models
from test_torch_train_model import _batch as _train_batch

from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.parallel import mesh as JMESH
from certifiedgpt_tpu.parallel import pipeline as JP
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.parallel import mesh as TMESH
from certifiedgpt_tpu_torch.parallel import pipeline as TP
from certifiedgpt_tpu_torch.parallel.processes import run_ranks

FORWARD_CASES = [(2, 4), (4, 2), (2, 1)]
#: tests/test_pipeline_parallel.py's tolerances: the forward, then the
#: loss and the gradient
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-5, 1e-7
#: tests/test_torch_train_model.py's train tolerances (loss, gradient),
#: W8A8 and weight-only int8
QUANT_TOL = {"w8a8": (2e-3, 2e-2), "int8_weight": (1e-5, 1e-4)}
RANKS = 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tiny_mgpt(jax_side: bool):
    """The JAX test's tiny MiniGPT-4 with 4 fp32 decoder layers."""
    if jax_side:
        cfg = JM.MiniGPT4Config.tiny()
        return dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, num_layers=4, dtype=jnp.float32))
    return TM.MiniGPT4Config.tiny(llama=TLM.LlamaConfig.tiny(num_layers=4))


def _tensors(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _grads(leaves):
    return {k: v.grad for k, v in leaves.items()}


def _forward_inputs():
    cfg = JLM.LlamaConfig.tiny(num_layers=4)
    params = JLM.init_llama(jax.random.PRNGKey(0), cfg)
    b, s = 8, 12
    ids = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, cfg.vocab_size)
    x = JLM.embed_tokens(params, ids)
    mask = (ids % 7 != 0).astype(jnp.int32)  # ragged validity
    pos = jnp.broadcast_to(jnp.arange(s), (b, s)).astype(jnp.int32)
    return cfg, params, x, mask, pos


_WORKER = """
import pickle
import numpy as np, torch
from certifiedgpt_tpu_torch.agents.finetune import data_parallel_loss
from certifiedgpt_tpu_torch.models import eva_vit as TV, llama as TLM, minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.parallel.mesh import gather_split_leaves, make_mesh, split_leaves
from certifiedgpt_tpu_torch.parallel.pipeline import (partition_llama_pipeline,
                                                      pipeline_llama_apply, stage_decoder)
data = pickle.load(open("inputs.pkl", "rb"))
to_t = lambda tree: {k: to_t(v) for k, v in tree.items()} if isinstance(tree, dict) \\
    else torch.from_numpy(np.array(tree))
tensors = lambda batch: {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                         else torch.from_numpy(v) for k, v in batch.items()}
out = {}

# (a) the forward
cfg = TLM.LlamaConfig.tiny(num_layers=4)
params = to_t(data["decoder"])
x, mask, pos = (torch.from_numpy(data[k]) for k in ("x", "mask", "pos"))
for n_pipe, n_micro in data["forward_cases"]:
    mesh = make_mesh(n_pipe=n_pipe)
    stage = partition_llama_pipeline(params, mesh)
    out["blocks", n_pipe] = stage["layers"]["q_proj"]["kernel"].shape[0]
    with torch.no_grad():
        logits, hidden = pipeline_llama_apply(stage, cfg, mesh.local_rows(x),
                                              mesh.local_rows(mask), mesh.local_rows(pos).long(),
                                              mesh, n_micro)
    out["forward", n_pipe, n_micro] = (mesh.gather_rows(logits), mesh.gather_rows(hidden))

# (b) loss and gradients, packed and unpacked; the decoder trainable too
mesh = make_mesh(n_pipe=2)
ct = TM.MiniGPT4Config.tiny(llama=TLM.LlamaConfig.tiny(num_layers=4))
for pack, batch in data["mgpt_batches"].items():
    model = MiniGPT4Model(ct, params_from_jax(data["mgpt"], ct, "cpu"), None)
    stage_decoder(model, mesh)
    trainable = model.make_trainable(("llama_proj", "llama"))
    leaves = [p for p in model.module.parameters()]
    batch = {k: mesh.local_rows(v) for k, v in tensors(batch).items()}
    loss = data_parallel_loss(model, batch, leaves, mesh, n_micro=2)
    grads = {"llama": {"layers": {m: {k: v.grad for k, v in leaf.items()}
                                  for m, leaf in trainable["llama"]["layers"].items()}}}
    out["loss", pack] = (float(loss),
                         {k: v.grad.clone() for k, v in trainable["llama_proj"].items()},
                         gather_split_leaves(grads, mesh, "cpu")["llama"]["layers"])
    # what a checkpoint holds and a resume keeps of this stage
    whole = gather_split_leaves(trainable, mesh, "cpu")
    arrays = gather_split_leaves({"0/mu/llama/layers/q_proj/kernel":
                            trainable["llama"]["layers"]["q_proj"]["kernel"].detach().numpy()},
                           mesh, "cpu")
    back = split_leaves(whole, mesh)
    out["round_trip", pack] = (
        whole["llama"]["layers"]["q_proj"]["kernel"].shape[0],
        all(torch.equal(back["llama"]["layers"][m][k], v)
            for m, leaf in trainable["llama"]["layers"].items() for k, v in leaf.items()),
        np.array_equal(split_leaves(arrays, mesh)["0/mu/llama/layers/q_proj/kernel"],
                       trainable["llama"]["layers"]["q_proj"]["kernel"].detach().numpy()))

# (c) the int8 decoders, llama_proj trainable
batch = tensors(data["quant_batch"])
for name, (w8a8, params) in data["quantized"].items():
    vit = dict(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla")
    cq = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                llama=TLM.LlamaConfig.tiny(act_quant=w8a8))
    model = MiniGPT4Model(cq, params_from_jax(params, cq, "cpu"), None)
    stage_decoder(model, mesh)
    trainable = model.make_trainable(("llama_proj",))
    loss = data_parallel_loss(model, {k: mesh.local_rows(v) for k, v in batch.items()},
                              list(trainable["llama_proj"].values()), mesh, n_micro=2)
    out["quant", name] = (float(loss),
                          {k: v.grad.clone() for k, v in trainable["llama_proj"].items()})
torch.save(out, f"outputs{RANK}.pt")
"""


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """Every rank's results of the 4-rank job, and the references: JAX
    ``llama_apply`` and ``pipeline_llama_apply``, ``jax.value_and_grad`` of
    the JAX pipeline loss, the port's one-process loss."""
    tmp = tmp_path_factory.mktemp("pipeline")
    cfg_j, params_j, x, mask, pos = _forward_inputs()
    mgpt_j = JM.init_minigpt4(jax.random.PRNGKey(0), _tiny_mgpt(True))
    mgpt = jax.tree.map(np.asarray, mgpt_j)
    batches = {pack: _mgpt_batches(_tiny_mgpt(True), pack) for pack in (1, 2)}
    quantized = {name: _quantized_models(w8a8) for name, w8a8 in QUANTIZED_DECODERS.items()}
    quant_batch = _train_batch(quantized["w8a8"][0], pack=1)
    with open(tmp / "inputs.pkl", "wb") as handle:
        pickle.dump({
            "decoder": jax.tree.map(np.asarray, params_j), "x": np.asarray(x),
            "mask": np.asarray(mask), "pos": np.asarray(pos), "forward_cases": FORWARD_CASES,
            "mgpt": mgpt, "mgpt_batches": batches, "quant_batch": quant_batch,
            "quantized": {name: (QUANTIZED_DECODERS[name], params)
                          for name, (_, params) in quantized.items()},
        }, handle)
    run_ranks(RANKS, _WORKER, str(tmp), timeout=600)
    ranks = [torch.load(tmp / f"outputs{r}.pt") for r in range(RANKS)]

    ref = {"sequential": JLM.llama_apply(params_j, cfg_j, x, mask, pos)[:2]}
    for n_pipe, n_micro in FORWARD_CASES:
        jmesh = _pipe_mesh(n_pipe, RANKS // n_pipe)
        ref["jax", n_pipe, n_micro] = JP.pipeline_llama_apply(
            JP.partition_llama_pipeline(params_j, jmesh), cfg_j, x, mask, pos, jmesh, n_micro)
    ct = _tiny_mgpt(False)
    trainable_j, frozen_j = JM.split_params(mgpt_j)
    for pack, batch in batches.items():
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jmesh = _pipe_mesh(2, 2)
        ref["jax_loss", pack] = jax.value_and_grad(lambda tr: JP.pipeline_minigpt4_loss(
            JM.merge_params(tr, frozen_j), _tiny_mgpt(True), jbatch, jmesh, n_micro=2))(
                trainable_j)
        model = MiniGPT4Model(ct, params_from_jax(mgpt, ct, "cpu"), None)
        trainable = model.make_trainable(("llama_proj", "llama"))
        loss = TM.minigpt4_loss(model.params, ct, _tensors(batch))
        loss.backward()
        ref["one", pack] = (float(loss.detach()), _grads(trainable["llama_proj"]),
                            trainable["llama"]["layers"])
    tbatch = _tensors(quant_batch)
    for name, (_, params) in quantized.items():
        w8a8 = QUANTIZED_DECODERS[name]
        vit = dict(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla")
        cq = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                    llama=TLM.LlamaConfig.tiny(act_quant=w8a8))
        model = MiniGPT4Model(cq, params_from_jax(params, cq, "cpu"), None)
        trainable = model.make_trainable(("llama_proj",))
        loss = TM.minigpt4_loss(model.params, cq, tbatch)
        loss.backward()
        ref["quant", name] = (float(loss.detach()), _grads(trainable["llama_proj"]))
    return ranks, ref


@pytest.mark.parametrize("n_pipe,n_micro", FORWARD_CASES)
def test_pipeline_forward_matches_jax(pipeline_runs, n_pipe, n_micro):
    """Logits and final hidden states of every rank (its data block's rows,
    gathered) within the JAX test's tolerance of JAX ``pipeline_llama_apply``
    and ``llama_apply``; each stage held 4 / n_pipe blocks."""
    ranks, ref = pipeline_runs
    want = [np.asarray(a) for a in ref["jax", n_pipe, n_micro]]
    seq = [np.asarray(a) for a in ref["sequential"]]
    for rank, got in enumerate(ranks):
        assert got["blocks", n_pipe] == 4 // n_pipe
        for g, w, s in zip(got["forward", n_pipe, n_micro], want, seq):
            np.testing.assert_allclose(g.numpy(), w, rtol=FWD_RTOL, atol=FWD_ATOL,
                                       err_msg=f"rank {rank}")
            np.testing.assert_allclose(g.numpy(), s, rtol=FWD_RTOL, atol=FWD_ATOL,
                                       err_msg=f"rank {rank}")


@pytest.mark.parametrize("pack", [1, 2])
def test_pipeline_loss_and_gradients_match_jax_and_one_process(pipeline_runs, pack):
    """pipe=2 x data=2 at 2 microbatches, through the reverse schedule: on
    every rank, the loss within 1e-5 relative and the ``llama_proj``
    gradient within rtol 5e-5, atol 1e-7 of ``jax.value_and_grad`` of the
    JAX pipeline loss and of the port's one-process ``minigpt4_loss``; the
    decoder's layer gradients (trainable too, each stage's blocks gathered)
    within the same of one process's. A checkpoint's gather and a resume's
    slice of the stage's blocks are each other's inverse."""
    ranks, ref = pipeline_runs
    jloss, jgrad = ref["jax_loss", pack]
    one_loss, one_grad, one_layers = ref["one", pack]
    for rank, got in enumerate(ranks):
        loss, grad, layers = got["loss", pack]
        np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, one_loss, rtol=LOSS_RTOL)
        for key in ("kernel", "bias"):
            np.testing.assert_allclose(grad[key].numpy(), np.asarray(jgrad["llama_proj"][key]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"rank {rank}")
            np.testing.assert_allclose(grad[key].numpy(), one_grad[key].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"rank {rank}")
        for mod, leaves in one_layers.items():
            for key, leaf in leaves.items():
                np.testing.assert_allclose(layers[mod][key].numpy(), leaf.grad.numpy(),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"rank {rank} {mod}/{key}")
        assert got["round_trip", pack] == (4, True, True)


@pytest.mark.parametrize("decoder", list(QUANTIZED_DECODERS))
def test_pipeline_quantized_decoders_match_one_process(pipeline_runs, decoder):
    """The W8A8 decoder of the shipped ``_w8a8`` YAML and a weight-only int8
    decoder on pipe=2 x data=2 at 2 microbatches: every rank's loss and
    ``llama_proj`` gradient within the train tolerances of
    tests/test_torch_train_model.py of one process's."""
    ranks, ref = pipeline_runs
    loss_tol, grad_tol = QUANT_TOL[decoder]
    one_loss, one_grad = ref["quant", decoder]
    for rank, got in enumerate(ranks):
        loss, grad = got["quant", decoder]
        assert abs(loss - one_loss) / abs(one_loss) < loss_tol, rank
        for key in ("kernel", "bias"):
            assert _rel(grad[key].numpy(), one_grad[key].numpy()) < grad_tol, (rank, key)


@pytest.mark.parametrize("knob", ["pipeline_parallel", "model_parallel"])
def test_split_decoder_finetune_agent_equals_one_process(train_set, tmp_path, knob):  # noqa: F811
    """``launch.main(["train", ...])`` with ``pipeline_parallel: 2`` on two
    gloo ranks (one stage each, 4 microbatches), or with ``model_parallel:
    2`` (the decoder's Megatron shards), the decoder trainable beside
    ``llama_proj`` and the gradient norm clipped, over two epochs: both
    ranks log the one-process losses, rank 0's checkpoint holds the whole
    decoder and its optimizer state, equal to one process's, as a JAX
    checkpoint of sharded arrays does, and rank 1 writes no checkpoint,
    history or metrics file."""
    run = dict(trainable_keys=["llama_proj", "llama"], max_grad_norm=0.05)
    out = f"split-{knob}"
    cfg = train_set(out, **run)
    path = tmp_path / "train.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    run_ranks(2, f"""
import json
from certifiedgpt_tpu_torch import launch
cfg = json.load(open({str(path)!r}))
cfg["run"].update(distributed=True, {knob}=2,
                  output_dir=cfg["run"]["output_dir"] + f"-rank{{RANK}}")
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
    want_hist = json.load(open(root / out / "loss_history.json"))
    got_hist = json.load(open(root / f"{out}-rank0" / "loss_history.json"))
    for split in ("train", "val"):
        assert len(got_hist[split]) == 2
        np.testing.assert_allclose(got_hist[split], want_hist[split], rtol=LOSS_RTOL)
    for rank in (0, 1):
        res = json.load(open(tmp_path / f"result{rank}.json"))
        assert res["epochs"] == want["epochs"] and res["steps"] == want["steps"]
        np.testing.assert_allclose(res["best_val"], want["best_val"], rtol=LOSS_RTOL)
    with np.load(root / f"{out}-rank0" / "vqa.npz") as got, \
            np.load(root / out / "vqa.npz") as ref:
        assert set(got.files) == set(ref.files)
        assert got["model:llama/layers/q_proj/kernel"].shape == \
            ref["model:llama/layers/q_proj/kernel"].shape
        assert any(k.startswith("opt:") and "llama/layers" in k for k in ref.files)
        for key in ref.files:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-6, err_msg=key)
    # rank 1 keeps its own log only
    assert {f.name for f in (root / f"{out}-rank1").iterdir()} <= {"certified.log"}


def test_pipeline_eval_agent_equals_one_process(vqa, tmp_path):  # noqa: F811
    """A serving agent under ``pipeline_parallel: 2`` on two gloo ranks
    (the eval agent at noise 0.5, two batches): each stage keeps the whole
    decoder and runs it sequentially on its data ranks' rows (all of them
    here), and rank 0's predictions and summary equal one process's."""
    cfg = vqa("image_text_eval", "pipe-eval", batch_size=2, noise_level=0.5,
              distributed=True, pipeline_parallel=2)
    path = tmp_path / "eval.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    run_ranks(2, f"""
import json
from certifiedgpt_tpu_torch import launch
cfg = json.load(open({str(path)!r}))
cfg["run"]["output_dir"] += f"-rank{{RANK}}"
json.dump(cfg, open(f"rank{{RANK}}.yaml", "w"))
launch.main(["eval", "--config-path", f"rank{{RANK}}.yaml", "--device", "cpu"])
""", str(tmp_path), timeout=240)
    one = dict(cfg["run"], distributed=False, pipeline_parallel=1)
    agent = setup_agent(Config(dict(cfg, run=one)), device="cpu")
    try:
        agent.run()
    finally:
        agent.finalize()
    root = vqa.root / "out"
    got = json.load(open(root / "pipe-eval-rank0" / "eval_results.json"))
    want = json.load(open(root / "pipe-eval" / "eval_results.json"))
    assert got == want and len(got["predictions"]) == 6
    assert not (root / "pipe-eval-rank1" / "eval_results.json").exists()


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_pipeline_refusals_use_the_jax_messages(train_set, monkeypatch):  # noqa: F811
    """Each refusal raises the JAX package's message: layers that do not
    divide into stages, a batch that does not divide into microbatches, a
    microbatch that does not divide the data axis, ``remat_every`` > 1, a
    pipe axis beside a dcn axis, ranks that do not divide into stages or a
    stage into ``model_parallel``, and pipe x model in the agents."""
    cfg_j, params_j, x, mask, pos = _forward_inputs()
    cfg_t = TLM.LlamaConfig.tiny(num_layers=4)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params_j)
    xt, mt, pt = (torch.from_numpy(np.array(a)) for a in (x, mask, pos))

    def both(jcfg, tcfg, n_pipe, n_data, n_micro, rows=8):
        jmesh = _pipe_mesh(n_pipe, n_data)
        tmesh = TMESH.ProcessMesh(1, n_data, 1, 0, n_pipe)
        local = rows // n_data
        want = _message(lambda: JP.pipeline_llama_apply(
            params_j, jcfg, x[:rows], mask[:rows], pos[:rows], jmesh, n_micro))
        got = _message(lambda: TP.pipeline_llama_apply(
            TP.partition_llama_pipeline(tparams, tmesh), tcfg, xt[:local], mt[:local],
            pt[:local].long(), tmesh, n_micro))
        assert got == want

    both(dataclasses.replace(cfg_j, num_layers=3), dataclasses.replace(cfg_t, num_layers=3),
         2, 1, 2)
    both(cfg_j, cfg_t, 2, 1, 3)
    both(cfg_j, cfg_t, 2, 2, 4, rows=4)
    remat = dict(remat=True, remat_every=2)
    both(dataclasses.replace(cfg_j, **remat), dataclasses.replace(cfg_t, **remat), 2, 1, 2)

    devices = jax.devices()
    assert _message(lambda: TMESH.make_mesh(n_pipe=2, n_dcn=2)) == _message(
        lambda: JMESH.make_mesh(devices=devices[:4], n_dcn=2, n_pipe=2))
    assert _message(lambda: TMESH.make_mesh(n_pipe=2)) == _message(
        lambda: JMESH.make_mesh(devices=devices[:1], n_pipe=2))
    monkeypatch.setattr(TMESH, "process_count", lambda: 4)
    assert _message(lambda: TMESH.make_mesh(n_pipe=2, n_model=3)) == _message(
        lambda: JMESH.make_mesh(devices=devices[:4], n_model=3, n_pipe=2))
    monkeypatch.undo()

    from certifiedgpt_tpu import registration  # noqa: F401 (the JAX agents)
    from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
    from certifiedgpt_tpu.common.config import Config as JConfig

    knobs = dict(pipeline_parallel=2, model_parallel=2)
    want = _message(lambda: j_setup_agent(JConfig(train_set("jax-pipe-model", **knobs))))
    got = _message(lambda: setup_agent(Config(train_set("pipe-model", **knobs)), device="cpu"))
    assert got == want
