"""Port parity of the training slice's host and op pieces, on the CPU: the
straight-through gradients of the W8A8 products, the weight-only int8
product's gradient, the label-smoothed CE under its three reductions, the
lr schedules, AdamW against optax (weight-decay mask, clip, gradient
accumulation, a plateau-set learning rate), the three training batch
builders, the train loader's order, and checkpoints written by one package
and read by the other, optimizer state included."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from certifiedgpt_tpu import optim as JO
from certifiedgpt_tpu.common import checkpoint as JC
from certifiedgpt_tpu.data import text as JT
from certifiedgpt_tpu.data.loader import Loader as JLoader
from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch import optim as TO
from certifiedgpt_tpu_torch.common import checkpoint as TC
from certifiedgpt_tpu_torch.common.metrics import StepMetrics
from certifiedgpt_tpu_torch.data import text as TT
from certifiedgpt_tpu_torch.data.loader import Loader
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.ops import quantization as TQ


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                 / np.linalg.norm(np.asarray(want, np.float64)))


def _quantized(rng, k, n):
    q = JQ.quantize_kernel(jnp.asarray(rng.randn(k, n).astype(np.float32) / np.sqrt(k)))
    return np.asarray(q["kernel_q"]), np.asarray(q["scale"])


# ----------------------------------------------------------------------
# the straight-through backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("form", ["w8a8", "w8a8_gelu", "weight_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_products_grad_matches_jax(form, dtype):
    """Forward and ``d sum(out * r) / dx`` against ``jax.grad`` of the JAX
    package's function (the two ``custom_vjp``s and the weight-only
    ``dense``): f32 1e-5 relative (summation order), bf16 1e-2 (one bf16
    rounding of the operands and outputs)."""
    rng = np.random.RandomState(3)
    kq, sc = _quantized(rng, 32, 24)
    x = (rng.randn(2, 5, 32) * 2).astype(np.float32)
    r = rng.randn(2, 5, 24).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
    jfn = {"w8a8": JQ.w8a8_matmul, "w8a8_gelu": JQ.w8a8_gelu_matmul,
           "weight_only": lambda a, q, s: JL.dense({"kernel_q": q, "scale": s}, a)}[form]
    tfn = {"w8a8": TQ.w8a8_matmul, "w8a8_gelu": TQ.w8a8_gelu_matmul,
           "weight_only": lambda a, q, s: TL.dense({"kernel_q": q, "scale": s}, a)}[form]

    def jloss(a):
        return jnp.sum(jfn(a, jnp.asarray(kq), jnp.asarray(sc)).astype(jnp.float32) * r)

    jout = jfn(jx, jnp.asarray(kq), jnp.asarray(sc))
    jgrad = jax.grad(jloss)(jx)
    tout = tfn(tx, torch.from_numpy(kq), torch.from_numpy(sc))
    (tout.float() * torch.from_numpy(r)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert tout.dtype == tdt and tx.grad.dtype == tdt
    assert _rel(tout.detach().float().numpy(), np.asarray(jout.astype(jnp.float32))) < tol
    assert _rel(tx.grad.float().numpy(), np.asarray(jgrad.astype(jnp.float32))) < tol


def test_w8a8_backward_saves_no_float_weight():
    """The straight-through backward keeps the int8 kernel and its scale,
    never a dequantized float copy of the weight or the activations."""
    rng = np.random.RandomState(0)
    kq, sc = _quantized(rng, 16, 8)
    x = torch.randn(4, 16, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        TQ.w8a8_matmul(x, torch.from_numpy(kq), torch.from_numpy(sc))
    assert [t.dtype for t in saved] == [torch.int8, torch.float32]
    assert [tuple(t.shape) for t in saved] == [(16, 8), (8,)]


# ----------------------------------------------------------------------
# the loss
# ----------------------------------------------------------------------
@pytest.mark.parametrize("reduction", ["mean", "none", "sum"])
def test_cross_entropy_matches_jax(reduction):
    """Label smoothing 0.1, the shift, -100 labels (a row with none
    valid): values and the gradient in the logits within 1e-5 relative."""
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    labels[2, :] = -100
    r = rng.randn(3).astype(np.float32)

    def jloss(lg):
        out = JLM.cross_entropy_loss(lg, jnp.asarray(labels), 0.1, reduction)
        return jnp.sum(out * (r if reduction != "mean" else 1.0))

    jval = JLM.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 0.1, reduction)
    jgrad = jax.grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tval = TLM.cross_entropy_loss(tl, torch.from_numpy(labels), 0.1, reduction)
    (tval * (torch.from_numpy(r) if reduction != "mean" else 1.0)).sum().backward()
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=1e-5, atol=1e-6)
    assert _rel(tl.grad.numpy(), np.asarray(jgrad)) < 1e-5


# ----------------------------------------------------------------------
# schedules and AdamW
# ----------------------------------------------------------------------
SCHEDULE_RUNS = [
    {"lr_sched": "linear_warmup_cosine_lr", "max_epoch": 15, "iters_per_epoch": 53,
     "warmup_steps": 53, "warmup_start_lr": 1e-6, "warmup_max_lr": 1e-5, "init_lr": 1e-5,
     "min_lr": 1e-6},
    {"lr_sched": "linear_warmup_cosine_lr", "max_epoch": 5, "iters_per_epoch": 7,
     "warmup_steps": 0, "init_lr": 3e-5, "min_lr": 1e-5},
    {"lr_sched": "constant_lr", "init_lr": 2e-4},
    {"lr_sched": "reduce_lr_on_plateau", "init_lr": 1e-3, "min_lr": 1e-6,
     "plateau_patience": 1, "plateau_factor": 0.5},
]


@pytest.mark.parametrize("run", SCHEDULE_RUNS, ids=lambda r: r["lr_sched"])
def test_lr_schedules_match_jax(run):
    """Every step of the budget (and past it) within 1e-6 relative (f32);
    the plateau scheduler's lr after each reported metric exactly."""
    js, ts = JO.build_lr_schedule(run), TO.build_lr_schedule(run)
    assert type(ts).__name__ == type(js).__name__
    for step in range(0, 15 * 53 + 20):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    if hasattr(js, "step_metric"):
        for value in (3.0, 2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0):
            assert ts.step_metric(value) == js.step_metric(value)


def _tree(rng):
    return {"llama_proj": {"kernel": rng.randn(6, 4).astype(np.float32),
                           "bias": rng.randn(4).astype(np.float32)},
            "ln_vision": {"scale": rng.randn(6, 2).astype(np.float32)}}


OPT_CASES = {
    "plain": dict(),
    "clip": dict(max_grad_norm=0.5),
    "accumulate": dict(accumulate_steps=2),
    "plateau": dict(stateful_lr=True, max_grad_norm=2.0, accumulate_steps=2),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_optax(case, tmp_path):
    """Eight steps of the port's AdamW against the JAX package's optax
    chain on the same gradients (the warmup-cosine schedule, weight decay
    masked by path: ``ln_vision`` and biases do not decay): parameters
    within 1e-6 relative. With the plateau scheduler the lr is set between
    steps as the agents set it. The state is then written in the JAX
    layout and read by ``JO``'s template, and back."""
    kw = OPT_CASES[case]
    rng = np.random.RandomState(5)
    params = _tree(rng)
    sched_run = SCHEDULE_RUNS[3] if kw.get("stateful_lr") else dict(SCHEDULE_RUNS[1],
                                                                      warmup_steps=3)
    jsched, tsched = JO.build_lr_schedule(sched_run), TO.build_lr_schedule(sched_run)
    tx = JO.make_optimizer(jsched, weight_decay=0.05, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = TL.tree_map(lambda a: torch.nn.Parameter(torch.from_numpy(a.copy())), params)
    opt = TO.AdamW(tparams, tsched, weight_decay=0.05, **kw)
    assert [g["weight_decay"] for g in opt.param_groups] == pytest.approx([0.05, 0.0])
    assert opt.param_groups[0]["paths"] == [("llama_proj", "kernel")]
    for step in range(8):
        grads = TL.tree_map(lambda a: (rng.randn(*a.shape) * (step + 1)).astype(np.float32),
                            params)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (path, p), (_, g) in zip(TO.flatten_tree(tparams), TO.flatten_tree(grads)):
            p.grad = torch.from_numpy(g)
        opt.step()
        if kw.get("stateful_lr") and step % 3 == 2:
            lr = 1e-3 * 0.5 ** (step // 3 + 1)
            jstate = JO.set_learning_rate(jstate, lr)
            opt.set_learning_rate(lr)
        for path, p in TO.flatten_tree(tparams):
            want = np.asarray(jparams[path[0]][path[1]])
            assert _rel(p.detach().numpy(), want) < 1e-6, (step, path)
    # the state in the JAX package's checkpoint layout, both ways
    path = str(tmp_path / "opt.npz")
    TC.save_checkpoint(path, tparams, opt.state_arrays(), {"epoch": 1})
    _, jrestored, meta = JC.load_checkpoint(path, jparams, tx.init(jparams))
    assert meta == {"epoch": 1}
    want_state = JC._flatten(jstate, "")
    for key, got in JC._flatten(jrestored, "").items():
        _close_state(got, want_state[key], key)
    JC.save_checkpoint(path, jparams, jstate, {})
    fresh = TO.AdamW(tparams, tsched, weight_decay=0.05, **kw)
    fresh.load_state_arrays(TC.load_opt_state(path))
    for key, value in fresh.state_arrays().items():
        _close_state(value, want_state[key], key)


def _close_state(got, want, key):
    """Counts exact; arrays within 1e-6 of their largest magnitude."""
    assert got.dtype == want.dtype and got.shape == want.shape, key
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=key)


def test_adamw_refuses_a_state_of_another_layout():
    p = {"llama_proj": {"kernel": torch.nn.Parameter(torch.zeros(2, 2))}}
    plain = TO.AdamW(p, TO.ConstantLR(1e-3))
    clipped = TO.AdamW(p, TO.ConstantLR(1e-3), max_grad_norm=1.0)
    with pytest.raises(KeyError, match="opt:1/0/count"):
        clipped.load_state_arrays(plain.state_arrays())
    with pytest.raises(ValueError, match="set_learning_rate"):
        plain.set_learning_rate(0.1)


# ----------------------------------------------------------------------
# batch builders and the train loader
# ----------------------------------------------------------------------
INSTRUCTIONS = ["<Img><ImageHere></Img> [vqa] what is in the picture?",
                "no image placeholder here, a rather long instruction " * 3,
                "<Img><ImageHere></Img> short", "<Img><ImageHere></Img> colour?",
                "<Img><ImageHere></Img> how many?", "<Img><ImageHere></Img> where"]
ANSWERS = ["a cat", "yes", "a rather long answer " * 4, "red", "two", "kitchen"]


@pytest.mark.parametrize("builder", ["train", "pack2", "pack3", "multiturn"])
@pytest.mark.parametrize("seq_len", [24, 48, 96])
def test_train_batch_builders_match_jax(builder, seq_len):
    """Every array equal, truncation included (the 24-slot budgets cut
    text, and pack 3 at 48 leaves 16 slots a segment)."""
    spec_j = JT.BatchSpec(seq_len=seq_len, num_img_tokens=4, max_answer_len=12)
    spec_t = TT.BatchSpec(seq_len=seq_len, num_img_tokens=4, max_answer_len=12)
    jtok, ttok = JT.ByteTokenizer(), TT.ByteTokenizer()
    if builder == "multiturn":
        convs = [[(INSTRUCTIONS[i], ANSWERS[i]), ("and then?", ANSWERS[-1 - i])]
                 for i in range(4)]
        want = JT.build_multiturn_train_batch(jtok, convs, spec_j)
        got = TT.build_multiturn_train_batch(ttok, convs, spec_t)
    elif builder == "train":
        want = JT.build_train_batch(jtok, INSTRUCTIONS, ANSWERS, spec_j)
        got = TT.build_train_batch(ttok, INSTRUCTIONS, ANSWERS, spec_t)
    else:
        pack = int(builder[-1])
        want = JT.pack_train_batch(jtok, INSTRUCTIONS, ANSWERS, spec_j, pack)
        got = TT.pack_train_batch(ttok, INSTRUCTIONS, ANSWERS, spec_t, pack)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


class _Items:
    def __init__(self, n):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, i):
        return {"i": i, "epoch": self.epoch}

    def collater(self, items):
        return {"i": np.array([it["i"] for it in items]),
                "epoch": [it["epoch"] for it in items]}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_train_loader_order_matches_jax(shuffle, drop_last):
    """The train loader's batches over three epochs (``set_epoch``), as the
    JAX ``Loader`` gives them under the same seed."""
    for epoch in range(3):
        batches = []
        for cls, kw in ((Loader, {}), (JLoader, {"process_index": 0, "process_count": 1})):
            loader = cls(_Items(11), batch_size=4, shuffle=shuffle, drop_last=drop_last,
                         seed=42, num_workers=2, **kw)
            loader.set_epoch(epoch)
            batches.append([(b["i"].tolist(), b["epoch"]) for b in loader])
        assert batches[0] == batches[1]
        assert len(batches[0]) == (2 if drop_last else 3)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def test_checkpoints_cross_both_ways(tmp_path):
    """A port-written checkpoint reads in the JAX ``load_checkpoint`` (keys
    letter for letter, f32 values exact, metadata) and a JAX-written one in
    the port's, into the template's dtype and device; bf16 leaves go as f32
    and come back exactly; the write is atomic (no temporary left)."""
    rng = np.random.RandomState(2)
    tree = {"llama_proj": {"kernel": rng.randn(5, 3).astype(np.float32),
                           "bias": rng.randn(3).astype(np.float32)},
            "qformer": {"query_tokens": rng.randn(1, 2, 5).astype(np.float32)}}
    ttree = TL.tree_map(torch.from_numpy, tree)
    ttree["qformer"]["query_tokens"] = ttree["qformer"]["query_tokens"].bfloat16()
    path = tmp_path / "port.npz"
    TC.save_checkpoint(str(path), ttree, None, {"epoch": 3, "val_loss": 1.5})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.npz", "port.npz.meta.json"]
    assert sorted(np.load(path).files) == sorted(JC._flatten(tree, "model:"))
    template = jax.tree.map(jnp.asarray, tree)
    template["qformer"]["query_tokens"] = template["qformer"]["query_tokens"].astype(jnp.bfloat16)
    got, opt, meta = JC.load_checkpoint(str(path), template)
    assert opt is None and meta == {"epoch": 3, "val_loss": 1.5}
    np.testing.assert_array_equal(np.asarray(got["llama_proj"]["kernel"]), tree["llama_proj"]["kernel"])
    assert got["qformer"]["query_tokens"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["qformer"]["query_tokens"].astype(jnp.float32)),
                                  ttree["qformer"]["query_tokens"].float().numpy())

    jpath = tmp_path / "jax.npz"
    JC.save_checkpoint(str(jpath), jax.tree.map(jnp.asarray, tree), None, {"epoch": 0})
    back, meta = TC.load_checkpoint(str(jpath), ttree)
    assert meta == {"epoch": 0} and TC.load_opt_state(str(jpath)) is None
    assert back["qformer"]["query_tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["llama_proj"]["bias"].numpy(), tree["llama_proj"]["bias"])


def test_step_metrics_rows(tmp_path):
    """The JAX package's columns; the compile counter of a function with no
    jit cache reads -1."""
    metrics = StepMetrics(str(tmp_path), "run")
    metrics.track("train_step", lambda: None)
    metrics.log_step_metrics("train", 1, 2, 3.25, lr=1e-5)
    metrics.log_event("done")
    rows = (tmp_path / "run.txt").read_text().splitlines()
    assert rows[0].endswith("split=train epoch=1 step=2 loss=3.250000 lr=0.00001000 "
                            "compiles[train_step]=-1")
    assert rows[1].endswith("event=done")
