"""Port parity of the train step's remaining XLA-fused code, on the CPU, where
each op takes its plain version: the straight-through input gradient of the
W8A8 product (``ops/quantization.py::_grad_input``) against JAX's
``_w8a8_bwd`` through ``jax.vjp`` of ``w8a8_matmul``; the training attention
(``ops/attention.py::training_attention``) and its q/k/v gradients against
``jax.vjp`` of the JAX ``multi_head_attention`` under the JAX training mask,
packed and unpacked, bf16 and f32, fully masked rows giving exact zeros; a
tiny W8A8 decoder's loss and input gradient through ``llama_apply`` under
``remat`` ``full`` and ``dots_all``; and the lm_head's gradients
(``models/llama.py::_LmHead``) against ``jax.vjp`` of the JAX
``lm_head_logits``. Inputs come from numpy with a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops import attention as JA
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu.ops.quantization import quantize_llama
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy
from certifiedgpt_tpu_torch.ops import attention as TA
from certifiedgpt_tpu_torch.ops import quantization as TQ

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ----------------------------------------------------------------------
# the straight-through input gradient
# ----------------------------------------------------------------------
# bf16: both round the same exact products' f32 sums to bf16 once, in other
# orders (a bf16 ulp flips in rare elements: 2^-8 of an element, far less in
# the norm); f32: the sums' order
GRAD_INPUT_REL = {"bf16": 4e-3, "f32": 1e-6}


@pytest.mark.parametrize("rows", [1, 7, 33])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_grad_input_matches_jax_w8a8_bwd(dtype, rows):
    """``_grad_input(g, kernel_q, scale, x dtype)`` against the input
    cotangent of ``jax.vjp`` of the JAX ``w8a8_matmul`` (its ``_w8a8_bwd``:
    ``w = bf16(f32(kernel_q) * scale)``, ``g @ w^T`` in g's dtype); the
    dequantized weight itself bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(rows)
    k, n = 48, 40
    q = JQ.quantize_kernel(jnp.asarray(rng.randn(k, n).astype(np.float32) / np.sqrt(k)))
    kq, sc = np.array(q["kernel_q"]), np.array(q["scale"])
    x = jnp.asarray(rng.randn(rows, k).astype(np.float32)).astype(jdt)
    g = jnp.asarray(rng.randn(rows, n).astype(np.float32)).astype(jdt)
    _, vjp = jax.vjp(lambda a: JQ.w8a8_matmul(a, jnp.asarray(kq), jnp.asarray(sc)), x)
    (want,) = vjp(g)
    tkq = TQ.int8_kernel_layout(torch.from_numpy(kq))
    got = TQ._grad_input(_to_torch(_np(g), tdt), tkq, torch.from_numpy(sc), tdt)
    assert got.dtype == tdt and got.shape == (rows, k)
    assert _rel(got, want) < GRAD_INPUT_REL[dtype], _rel(got, want)
    w = (jnp.asarray(kq).astype(jnp.float32) * jnp.asarray(sc)[None, :]).astype(jnp.bfloat16)
    tw = TQ._dequantized_t(tkq, torch.from_numpy(sc), torch.bfloat16).t()
    assert np.array_equal(_np(tw), _np(w))


# ----------------------------------------------------------------------
# the training attention
# ----------------------------------------------------------------------
# bf16: the weights rounded to bf16 before P v and every output rounded to
# bf16 (a flip moves an element by 2^-8 relative); f32: the sums' order
ATTN_REL = {"bf16": 1.5e-2, "f32": 1e-5}


def _attention_case(packed: bool, h_kv: int):
    """Two rows of 10 slots, 4 heads of 16: packed, three segments in the
    first row and two in the second, whose last two slots are pad (segment
    0, invalid); unpacked, the second row's first two slots invalid (left
    padding), so its first two queries see no key at all."""
    b, s, h, d = 2, 10, 4, 16
    rng = np.random.RandomState(5 + packed + h_kv)
    q, k, v = (rng.randn(b, s, hh, d).astype(np.float32) for hh in (h, h_kv, h_kv))
    g = rng.randn(b, s, h, d).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    if packed:
        seg = np.array([[1, 1, 1, 2, 2, 2, 2, 3, 3, 3], [1, 1, 1, 1, 2, 2, 2, 2, 0, 0]], np.int32)
        mask[1, 8:] = 0
        dead = [(1, 8), (1, 9)]
    else:
        seg = None
        mask[1, :2] = 0
        dead = [(1, 0), (1, 1)]
    return q, k, v, g, mask, seg, dead


def _jax_training_mask(mask, seg, s):
    jm = jnp.tril(jnp.ones((s, s), jnp.bool_))[None, None] & jnp.asarray(mask)[:, None, None,
                                                                             :].astype(bool)
    if seg is not None:
        jm = jm & (jnp.asarray(seg)[:, :, None] == jnp.asarray(seg)[:, None, :])[:, None]
    return jm


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_training_attention_matches_jax_vjp(dtype, packed, h_kv):
    """``training_attention`` (its plain version on the CPU) and its q, k, v
    gradients within ``ATTN_REL`` of ``jax.vjp`` of the JAX
    ``multi_head_attention`` under the JAX training mask; the queries that
    see no key give exact zeros and exact zero gradients, and the keys no
    query sees get exact zero gradients."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, g, mask, seg, dead = _attention_case(packed, h_kv)
    jm = _jax_training_mask(mask, seg, q.shape[1])
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    jout, vjp = jax.vjp(lambda a, b, c: JA.multi_head_attention(a, b, c, jm), jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv = (_to_torch(_np(a), tdt).requires_grad_(True) for a in (jq, jk, jv))
    out = TA.training_attention(tq, tk, tv, torch.from_numpy(mask),
                                None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad(out, (tq, tk, tv), _to_torch(_np(jg), tdt))
    assert out.dtype == tdt
    assert _rel(out, jout) < ATTN_REL[dtype], _rel(out, jout)
    for got, want in zip(grads, jgrads):
        assert got.dtype == tdt
        assert _rel(got, want) < ATTN_REL[dtype], _rel(got, want)
    for row, i in dead:
        assert not out[row, i].any() and not grads[0][row, i].any()
        if not packed:  # key i is invalid: no query sees it
            assert not grads[1][row, i].any() and not grads[2][row, i].any()
    assert np.array_equal(_np(out[1, [i for _, i in dead]]), _np(jout[1, [i for _, i in dead]]))


def test_training_mask_is_the_jax_mask():
    """``training_mask`` (the plain path's dense mask) equals the JAX
    training mask, packed and unpacked."""
    for packed in (True, False):
        _, _, _, _, mask, seg, _ = _attention_case(packed, 4)
        got = TA.training_mask(torch.from_numpy(mask),
                               None if seg is None else torch.from_numpy(seg), 10, "cpu")
        assert np.array_equal(got.numpy(), np.asarray(_jax_training_mask(mask, seg, 10)))


# ----------------------------------------------------------------------
# a tiny decoder's loss and input gradient
# ----------------------------------------------------------------------
# bf16: every activation rounded to bf16 and the W8A8 codes of two
# implementations that round their inputs a little apart; the loss averages
DECODER_LOSS_REL, DECODER_GRAD_REL = 1e-2, 5e-2


def _tiny_decoder():
    cfg_j = JLM.LlamaConfig.tiny(num_layers=2, act_quant=True, dtype=jnp.bfloat16)
    params = JLM.init_llama(jax.random.PRNGKey(4), cfg_j)
    rng = np.random.RandomState(6)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)
    params = quantize_llama(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params))
    return cfg_j, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("policy", ["full", "dots_all"])
def test_tiny_decoder_loss_and_grad_match_jax(policy):
    """A tiny bf16 W8A8 decoder, packed (three segments and pad slots),
    under ``remat_policy`` ``policy``: the label-smoothed loss through
    ``llama_apply`` within ``DECODER_LOSS_REL`` of the JAX one, its gradient
    in the input embeddings within ``DECODER_GRAD_REL``; remat changes no
    bit."""
    cfg_j, params = _tiny_decoder()
    cfg_t = TLM.LlamaConfig.tiny(num_layers=2, act_quant=True, dtype=torch.bfloat16, remat=True,
                                 remat_policy=policy)
    b, s = 2, 12
    rng = np.random.RandomState(8)
    x = rng.randn(b, s, cfg_j.hidden_size).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0
    seg = np.array([[1] * 4 + [2] * 5 + [3] * 3, [1] * 6 + [2] * 4 + [0] * 2], np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        for sid in set(seg[r].tolist()) - {0}:
            idx = np.where(seg[r] == sid)[0]
            pos[r, idx] = np.arange(len(idx))
    labels = rng.randint(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    labels[1, 10:] = JLM.IGNORE_INDEX

    def jloss(emb):
        logits, _, _ = JLM.llama_apply(jax.tree.map(jnp.asarray, params), cfg_j, emb,
                                       jnp.asarray(mask), jnp.asarray(pos),
                                       segment_ids=jnp.asarray(seg))
        return JLM.cross_entropy_loss(logits, jnp.asarray(labels))

    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jval, jgrad = jax.value_and_grad(jloss)(jx)
    tparams = TL.tree_map(tensor_from_numpy, params)

    def run(cfg):
        emb = _to_torch(_np(jx), torch.bfloat16).requires_grad_(True)
        logits, _, _ = TLM.llama_apply(tparams, cfg, emb, torch.from_numpy(mask),
                                       torch.from_numpy(pos).long(),
                                       segment_ids=torch.from_numpy(seg))
        loss = TLM.cross_entropy_loss(logits, torch.from_numpy(labels).long())
        (grad,) = torch.autograd.grad(loss, emb)
        return float(loss.detach()), grad

    loss, grad = run(cfg_t)
    assert abs(loss - float(jval)) / abs(float(jval)) < DECODER_LOSS_REL
    assert _rel(grad, jgrad) < DECODER_GRAD_REL, _rel(grad, jgrad)
    loss0, grad0 = run(dataclasses.replace(cfg_t, remat=False))
    assert loss == loss0 and torch.equal(grad, grad0)


# ----------------------------------------------------------------------
# the lm_head under autograd
# ----------------------------------------------------------------------
@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_lm_head_grads_match_jax_vjp(dtype, trainable):
    """``lm_head_logits`` where autograd records it: the f32 logits equal
    the JAX ``lm_head_logits`` (exact products, f32 sums: within 1e-6), the
    hidden rows' gradient (the f32 cotangent times the head in f32, rounded
    to the rows' dtype) and a trainable head's within ``GRAD_INPUT_REL``
    of ``jax.vjp``."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(9)
    d, vocab = 24, 40
    hidden = jnp.asarray(rng.randn(2, 3, d).astype(np.float32)).astype(jdt)
    head = jnp.asarray((rng.randn(d, vocab) / np.sqrt(d)).astype(np.float32)).astype(jdt)
    g = rng.randn(2, 3, vocab).astype(np.float32)
    jlogits, vjp = jax.vjp(lambda h, w: JLM.lm_head_logits({"lm_head": {"kernel": w}}, h),
                           hidden, head)
    jgh, jgw = vjp(jnp.asarray(g))
    th = _to_torch(_np(hidden), tdt).requires_grad_(True)
    tw = _to_torch(_np(head), tdt).requires_grad_(trainable)
    logits = TLM.lm_head_logits({"lm_head": {"kernel": tw}}, th)
    assert logits.dtype == torch.float32
    assert _rel(logits, jlogits) < 1e-6
    grads = torch.autograd.grad(logits, (th, tw) if trainable else (th,), torch.from_numpy(g))
    assert grads[0].dtype == tdt
    assert _rel(grads[0], jgh) < GRAD_INPUT_REL[dtype], _rel(grads[0], jgh)
    if trainable:
        assert grads[1].dtype == tdt
        assert _rel(grads[1], jgw) < GRAD_INPUT_REL[dtype], _rel(grads[1], jgw)
