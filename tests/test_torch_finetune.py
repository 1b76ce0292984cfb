"""Port parity of the finetune agent, on the CPU: at noise 0 on the same
weights and the same written VQAv2 set, the port's ``FinetuneAgent``
trains as the JAX agent does over two epochs of packed batches (per-epoch
train and val losses, the learning rates of the step rows, the best epoch,
the ``llama_proj`` it saves, ``loss_history.json``), resumes from a
JAX-written checkpoint with its optimizer state and ends where the JAX
agent's uninterrupted run ends, and its ``_best`` checkpoint is a
``model.vqa_finetuned`` for both packages' certify agents. The ``train``
CLI runs on the CPU in a subprocess when asked and stops without CUDA
otherwise; the knobs the port does not have are refused."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_launch import jax_tree, port_on_jax_weights  # noqa: F401

from certifiedgpt_tpu import registration as j_registration  # noqa: F401
from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.common.checkpoint import load_checkpoint as j_load_checkpoint
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu_torch import launch
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.agents.finetune import FinetuneAgent, noise_seed
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.common.registry import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX agents lay batches over the suite's 8 virtual devices: 16 rows
# packed 2 to a row give 8 rows
BATCH, PACK = 16, 2
N_TRAIN, N_VAL = 32, 20  # two train steps an epoch; the second val batch padded from 4


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """Written VQAv2 train and val splits (32-px JPEGs, several answers a
    question) and ``make(out, **run)``: a finetune config for them."""
    root = tmp_path_factory.mktemp("train")
    (root / "images").mkdir()
    rng = np.random.RandomState(0)
    words = ["cat", "dog", "two", "red", "yes", "no", "kitchen", "a blue car"]
    for split, n, base in (("train", N_TRAIN, 5000), ("val", N_VAL, 6000)):
        questions, annotations = [], []
        for i in range(n):
            image_id = base + i
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root / "images" / f"COCO_{split}2014_{image_id:012d}.jpg")
            questions.append({"question_id": base + i, "image_id": image_id,
                              "question": f"what is in picture {i}?"})
            annotations.append({"question_id": base + i, "image_id": image_id,
                                "answers": [{"answer": words[(i + j) % len(words)],
                                             "answer_confidence": ("yes", "maybe")[j % 2]}
                                            for j in range(3)]})
        (root / f"{split}_q.json").write_text(json.dumps({"questions": questions}))
        (root / f"{split}_a.json").write_text(json.dumps({"annotations": annotations}))

    def make(out, **run_extra):
        run = {"agent": "image_text_finetune", "max_epoch": 2, "patience": 5,
               "batch_size": BATCH, "seq_len": 96, "pack_sequences": PACK,
               "noise_level": 0.0, "lr_sched": "linear_warmup_cosine_lr",
               "iters_per_epoch": 2, "warmup_steps": 2, "warmup_start_lr": 1e-4,
               "warmup_max_lr": 1e-3, "init_lr": 1e-3, "min_lr": 1e-4, "weight_decay": 0.05,
               "seed": 7, "num_workers": 2, "checkpoint_name": "vqa",
               "output_dir": str(root / "out" / out)}
        run.update(run_extra)
        return {
            "model": {"arch": "minigpt4", "model_size": "tiny"},
            "datasets": {"vqav2": {
                "vis_processor": {"train": {"name": "blip2_image_train", "image_size": 28},
                                  "val": {"name": "blip2_image_val", "image_size": 28}},
                "text_processor": {"train": {"name": "blip_caption"}},
                "build_info": {
                    "images": {"storage": str(root / "images")},
                    "questions": {s: [str(root / f"{s}_q.json")] for s in ("train", "val")},
                    "annotations": {s: [str(root / f"{s}_a.json")] for s in ("train", "val")},
                },
            }},
            "run": run,
        }

    make.root = root
    return make


def _run(make, side, out, **run):
    cfg = make(out, **run)
    agent = (j_setup_agent(JConfig(cfg)) if side == "jax"
             else setup_agent(Config(cfg), device="cpu"))
    result = agent.run()
    agent.finalize()
    return result, make.root / "out" / out


def _proj(path, template):
    tree, _, meta = j_load_checkpoint(str(path), template)
    return {k: np.asarray(v) for k, v in tree["llama_proj"].items()}, meta


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _lrs(path):
    return [float(row.split(" lr=")[1].split()[0]) for row in open(path).read().splitlines()
            if " split=train " in row]


@pytest.fixture(scope="module")
def jax_two_epochs(train_set, jax_tree):  # noqa: F811
    return _run(train_set, "jax", "jax-2")


def test_finetune_matches_jax_at_noise_zero(train_set, port_on_jax_weights,  # noqa: F811
                                            jax_tree, jax_two_epochs):  # noqa: F811
    """Losses within 1e-5 relative each epoch (f32, summation order), the
    same best epoch and step learning rates, the saved projection within
    1e-4 relative (AdamW's normalized steps carry the loss's last-ulp
    differences), the same artifacts."""
    j_result, j_out = jax_two_epochs
    t_result, t_out = _run(train_set, "torch", "torch-2")
    want = json.load(open(j_out / "loss_history.json"))
    got = json.load(open(t_out / "loss_history.json"))
    assert len(got["train"]) == len(got["val"]) == 2
    for split in ("train", "val"):
        np.testing.assert_allclose(got[split], want[split], rtol=1e-5)
    assert t_result["epochs"] == j_result["epochs"] == 2
    assert t_result["steps"] == j_result["steps"] == 4
    assert t_result["best_val"] == pytest.approx(j_result["best_val"], rel=1e-5)
    np.testing.assert_allclose(_lrs(t_out / "vqa.txt"), _lrs(j_out / "vqa.txt"), rtol=1e-6)
    assert "compiles[train_step]=-1" in open(t_out / "vqa.txt").read()
    template = jax.tree.map(jnp.asarray, {"llama_proj": jax_tree["llama_proj"]})
    for name in ("vqa", "vqa_best"):
        got_p, got_meta = _proj(t_out / f"{name}.npz", template)
        want_p, want_meta = _proj(j_out / f"{name}.npz", template)
        assert got_meta["epoch"] == want_meta["epoch"]
        for key in ("kernel", "bias"):
            assert _rel(got_p[key], want_p[key]) < 1e-4, (name, key)
    for f in ("vqa.npz", "vqa_best.npz", "loss_history.json", "loss_history.png", "vqa.txt"):
        assert (t_out / f).exists() and (j_out / f).exists(), f
    assert sorted(np.load(t_out / "vqa.npz").files) == sorted(np.load(j_out / "vqa.npz").files)
    assert [k for k in np.load(t_out / "vqa_best.npz").files if k.startswith("opt:")] == []


def test_resume_from_a_jax_checkpoint(train_set, port_on_jax_weights,  # noqa: F811
                                      jax_tree, jax_two_epochs):  # noqa: F811
    """The JAX agent trains epoch 0 and writes its resume checkpoint (with
    the optax state); the port resumes from it, trains epoch 1 and ends
    where the JAX agent's uninterrupted two-epoch run ends."""
    _, j_out = jax_two_epochs
    _, first = _run(train_set, "jax", "jax-1", max_epoch=1)
    result, t_out = _run(train_set, "torch", "torch-resumed",
                         resume_ckpt_path=str(first / "vqa.npz"))
    assert result["steps"] == 2 and result["epochs"] == 2
    template = jax.tree.map(jnp.asarray, {"llama_proj": jax_tree["llama_proj"]})
    got, meta = _proj(t_out / "vqa.npz", template)
    want, _ = _proj(j_out / "vqa.npz", template)
    assert meta == {"epoch": 1, "global_step": 4}
    for key in ("kernel", "bias"):
        assert _rel(got[key], want[key]) < 1e-4, key
    history = json.load(open(t_out / "loss_history.json"))
    np.testing.assert_allclose(history["train"], json.load(
        open(j_out / "loss_history.json"))["train"][1:], rtol=1e-5)


def test_port_checkpoint_is_a_vqa_finetuned_for_both_certify_agents(
        train_set, port_on_jax_weights, jax_tree):  # noqa: F811
    """A projection the port trained (``{name}_best.npz``) is read as
    ``model.vqa_finetuned`` by the port's and the JAX package's certify
    agents."""
    _, out = _run(train_set, "torch", "torch-best", max_epoch=1)
    best = str(out / "vqa_best.npz")
    want = np.load(best)["model:llama_proj/kernel"]
    cfg = train_set("certify", agent="image_text_certify")
    cfg["model"]["vqa_finetuned"] = best
    port = setup_agent(Config(cfg), device="cpu")
    np.testing.assert_array_equal(port.model.params["llama_proj"]["kernel"].numpy(), want)
    jagent = j_setup_agent(JConfig(cfg))
    np.testing.assert_array_equal(np.asarray(jagent.model.params["llama_proj"]["kernel"]), want)


def test_only_the_projection_requires_grad(train_set):
    agent = setup_agent(Config(train_set("grad")), device="cpu")
    assert isinstance(agent, FinetuneAgent)
    trainable = {n for n, p in agent.model.module.named_parameters()}
    assert trainable == {"llama_proj.kernel", "llama_proj.bias"}
    assert [p for g in agent.optimizer.param_groups for p in g["params"]] == [
        agent.model.module.llama_proj.kernel, agent.model.module.llama_proj.bias]
    assert not any(b.requires_grad for b in agent.model.module.buffers())


def test_early_stopping_on_patience(train_set):
    """At a learning rate of 0 the val loss never improves on epoch 0's, so
    with patience 1 the run stops after epoch 1 of 5; the best checkpoint
    is epoch 0's."""
    result, out = _run(train_set, "torch", "patience", max_epoch=5, patience=1,
                       lr_sched="constant_lr", init_lr=0.0)
    assert result["epochs"] == 2 and result["steps"] == 4
    history = json.load(open(out / "loss_history.json"))
    assert len(history["val"]) == 2 and history["val"][0] == history["val"][1]
    assert json.load(open(out / "vqa_best.npz.meta.json"))["epoch"] == 0
    assert json.load(open(out / "vqa.npz.meta.json"))["epoch"] == 1


def test_debug_graph_and_evaluate_only(train_set):
    debug, out = _run(train_set, "torch", "debug", debug_graph_computation=True)
    assert debug["steps"] == 1 and np.isfinite(debug["loss"])
    assert (out / "debug_ckpt.npz").exists()
    assert "event=debug_graph_computation loss=" in open(out / "vqa.txt").read()
    result, _ = _run(train_set, "torch", "evaluate", evaluate=True)
    assert result["evaluate_only"] and np.isfinite(result["val_loss"])


def test_noise_keys_by_epoch_and_step(train_set, monkeypatch):
    """Each step's noise generator is seeded by (seed, epoch, step in the
    epoch), each validation batch's by (seed, VAL_NOISE_KEY, batch)."""
    from certifiedgpt_tpu_torch.agents import finetune as TF

    seen = []
    noise = TF.add_input_noise

    def spy(images, sigma, dist, generator):
        seen.append(generator.initial_seed())
        return noise(images, sigma, dist, generator)

    monkeypatch.setattr(TF, "add_input_noise", spy)
    _run(train_set, "torch", "noisy", noise_level=0.5)
    step = lambda e, s: noise_seed(7, e, s)  # noqa: E731
    val = [noise_seed(7, TF.VAL_NOISE_KEY, b) for b in range(2)]
    assert seen == [step(0, 0), step(0, 1), *val, step(1, 0), step(1, 1), *val]


@pytest.mark.parametrize("knob,value,error,match", [
    ("pipeline_parallel", 2, ValueError, "pipeline_microbatches=3"),
    ("enable_profile", True, NotImplementedError, "item 16"),
    ("pack_sequences", 3, ValueError, "not divisible"),
    ("seq_len", 20, ValueError, "segment budget"),
])
def test_finetune_refusals(train_set, tmp_path, knob, value, error, match):
    """Config errors raise before a step. ``enable_profile`` (item 16) is
    ported: a one-step run traces its step 0 (``profile_epoch`` 0) into a
    Chrome trace. ``pipeline_parallel`` (item 17) is ported: on two gloo
    ranks each keeps its stage's block of every stacked decoder leaf (the
    one-process stack's rows), runs 2 x 2 microbatches by default, and
    ``pipeline_microbatches`` 3, which does not divide the 8 decoder rows,
    raises the JAX agent's message."""
    if knob == "enable_profile":
        logdir = tmp_path / "trace"
        _run(train_set, "torch", "profiled", max_epoch=1, iters_per_epoch=1,
             has_val_split=False, enable_profile=True, duration_ms=60000,
             profile_logdir=str(logdir))
        traces = list(logdir.glob("trace_rank0_epoch0_step0.json"))
        assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
        return
    if knob == "pipeline_parallel":
        from certifiedgpt_tpu_torch.parallel.processes import run_ranks

        cfg = train_set("staged", distributed=True, **{knob: value})
        path = tmp_path / "staged.yaml"
        path.write_text(json.dumps(cfg))  # JSON is YAML
        run_ranks(2, f"""
import json, pytest, torch
from certifiedgpt_tpu_torch import registration
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
cfg = json.load(open({str(path)!r}))
agent = setup_agent(Config(cfg), device="cpu")
torch.save((agent.n_micro, agent.model.params["llama"]["layers"]), f"layers{{RANK}}.pt")
agent.finalize()
cfg["run"]["pipeline_microbatches"] = 3
with pytest.raises({error.__name__}, match={match!r}):
    setup_agent(Config(cfg), device="cpu")
""", str(tmp_path), timeout=240)
        whole = setup_agent(Config(train_set("whole")), device="cpu").model.params["llama"]
        for rank in (0, 1):
            n_micro, layers = torch.load(tmp_path / f"layers{rank}.pt")
            assert n_micro == 4
            for mod, leaves in layers.items():
                for leaf, block in leaves.items():
                    want = whole["layers"][mod][leaf]
                    assert block.shape[0] * 2 == want.shape[0]
                    assert torch.equal(block, want.chunk(2)[rank]), (rank, mod, leaf)
        return
    with pytest.raises(error, match=match):
        setup_agent(Config(train_set("refused", **{knob: value})), device="cpu")


def _cli(args, cwd, **env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-m", "certifiedgpt_tpu_torch.launch", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_cli_train_on_the_cpu(train_set, tmp_path):
    """``train --device cpu`` trains, validates and writes the artifacts;
    without ``--device`` it runs on the card, so with no CUDA it stops
    non-zero and falls back to nothing."""
    path = tmp_path / "train.yaml"
    cfg = train_set("cli", max_epoch=2)
    del cfg["run"]["agent"]
    path.write_text(json.dumps(cfg))  # JSON is YAML
    proc = _cli(["train", "--config-path", str(path), "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = train_set.root / "out" / "cli"
    history = json.load(open(out / "loss_history.json"))
    assert len(history["train"]) == len(history["val"]) == 2
    assert all(np.isfinite(history["train"] + history["val"]))
    for f in ("vqa.npz", "vqa.npz.meta.json", "vqa_best.npz", "vqa.txt", "certified.log"):
        assert (out / f).exists(), f
    proc = _cli(["train", "--config-path", str(path)], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr


def test_launcher_routes_train_to_image_text_finetune(train_set, tmp_path):
    cfg = train_set("routed", max_epoch=1)
    del cfg["run"]["agent"]
    path = tmp_path / "train.yaml"
    path.write_text(json.dumps(cfg))
    result = launch.main(["train", "--config-path", str(path), "--device", "cpu"])
    assert registry.get("configuration").run.agent == "image_text_finetune"
    assert registry.get("mode") == "train" and result["steps"] == 2
    assert torch.isfinite(torch.tensor(result["best_val"]))
