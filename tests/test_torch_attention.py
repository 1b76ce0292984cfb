"""Port parity: attention ops (certifiedgpt_tpu_torch/ops/attention.py and
the cls-split attention's plain version in ops/flash_attention.py) against
the JAX package on the CPU, in f32 (atol 1e-5: summation order only)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.ops import attention as JA
from certifiedgpt_tpu.ops import flash_attention as JF
from certifiedgpt_tpu.ops.quantization import quantize_rows as j_quantize_rows
from certifiedgpt_tpu_torch.ops import attention as TA
from certifiedgpt_tpu_torch.ops import flash_attention as TF


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask(rng, b, sq, sk):
    mask = rng.rand(b, 1, sq, sk) > 0.3
    mask[0, 0, 1, :] = False  # one fully masked query row
    return mask


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_multi_head_attention_matches_jax(h_kv):
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 4, 8).astype(np.float32)
    k = rng.randn(2, 7, h_kv, 8).astype(np.float32)
    v = rng.randn(2, 7, h_kv, 8).astype(np.float32)
    mask = _mask(rng, 2, 5, 7)
    want = np.asarray(JA.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jnp.asarray(mask)))
    got = TA.multi_head_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[0, 1] == 0.0)  # fully masked row: zeros, not NaN
    nomask = TA.multi_head_attention(_t(q), _t(k), _t(v), scale=0.3).numpy()
    np.testing.assert_allclose(
        nomask, np.asarray(JA.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), scale=0.3)), atol=1e-5)


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_multi_head_attention_kv8_matches_jax(h_kv):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 3, 4, 8).astype(np.float32)
    k = rng.randn(2, 6, h_kv, 8).astype(np.float32)
    v = rng.randn(2, 6, h_kv, 8).astype(np.float32)
    kq, ks = (np.asarray(a) for a in j_quantize_rows(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in j_quantize_rows(jnp.asarray(v)))
    mask = _mask(rng, 2, 3, 6)
    want = np.asarray(JA.multi_head_attention_kv8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(mask)))
    got = TA.multi_head_attention_kv8(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[0, 1] == 0.0)


@pytest.mark.parametrize("d", [8, 16], ids=["unpadded", "lane_padded"])
def test_cls_split_attention_plain_matches_jax(d):
    """The port keeps the true head dim; the JAX package pads it. Both give
    the same function on zero-padded operands."""
    rng = np.random.RandomState(2)
    b, h, n = 2, 3, 128
    prem = (8 ** -0.5) * TF.CLS_SPLIT_Q_PREMUL_LOG2E
    parts = []
    for s, is_q in ((n, True), (n, False), (n, False), (1, True), (1, False), (1, False)):
        a = np.zeros((b, h, s, d), np.float32)
        a[..., :8] = rng.randn(b, h, s, 8) * (prem if is_q else 1.0)
        parts.append(a)
    qp, kp, vp, qc, kc, vc = parts
    jc, jp = JF.cls_split_attention_parts(*(jnp.asarray(a) for a in parts))
    tc, tp = TF.cls_split_attention_parts(*(_t(a) for a in parts))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    # the exp2 cls row that the CUDA path uses agrees with the fallback
    row = TF._cls_query_row(_t(qc), _t(kp), _t(vp), _t(kc), _t(vc))
    np.testing.assert_allclose(row.numpy(), np.asarray(jc), atol=1e-5)
    # and plain softmax attention over the natural-log scores
    q = np.concatenate([qc, qp], 2) / TF.CLS_SPLIT_Q_PREMUL_LOG2E
    k = np.concatenate([kc, kp], 2)
    v = np.concatenate([vc, vp], 2)
    s = np.einsum("bhqd,bhkd->bhqk", q, k)
    w = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(tp.numpy(), ref[:, :, 1:], atol=1e-5)
    assert math.isclose(TF.CLS_SPLIT_Q_PREMUL_LOG2E, float(JF.CLS_SPLIT_Q_PREMUL_LOG2E))


def test_cls_split_attention_counts_no_launch_on_cpu():
    x = torch.randn(1, 2, 64, 8)
    c = torch.randn(1, 2, 1, 8)
    before = TF.cls_split_attention_parts.launches
    TF.cls_split_attention_parts(x, x, x, c, c, c)
    assert TF.cls_split_attention_parts.launches == before


@pytest.mark.parametrize("shape", [(2, 64, 4, 32), (2, 33, 4, 8)], ids=["tiles", "tail"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_matches_jax(shape, causal):
    """flash_attention against the JAX wrapper's CPU path (its
    multi_head_attention with a tril mask), with and without an explicit
    scale; 33 tokens leave a ragged tail in any tiling."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    for scale in (None, 0.2):
        want = np.asarray(JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, scale=scale))
        got = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal, scale=scale).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    if causal:  # the first query sees only the first key
        np.testing.assert_allclose(got[:, 0], v[:, 0], atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 4, 32), (2, 33, 4, 8)], ids=["tiles", "tail"])
def test_builtin_flash_attention_matches_jax(shape):
    """Both library-kernel forms against the JAX wrappers' CPU paths: the
    [B, S, H, D] form, and the [B, H, S, D] form with the scale taken from
    the true head dim of lane-padded operands."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = np.asarray(JF.builtin_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = TF.builtin_flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    d = shape[-1]
    pad = [np.zeros(a.shape[:3] + (d + 8,), np.float32) for a in (q, k, v)]
    for a, src in zip(pad, (q, k, v)):
        a[..., :d] = src
    qh, kh, vh = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in pad)
    want = np.asarray(JF.builtin_flash_attention_bhsd(jnp.asarray(qh), jnp.asarray(kh),
                                                      jnp.asarray(vh), d))
    got = TF.builtin_flash_attention_bhsd(_t(qh), _t(kh), _t(vh), d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[..., :d], np.asarray(
        JF.builtin_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ).transpose(0, 2, 1, 3), atol=1e-5)


def _jax_cls_split_scaled(q, k, v, true_head_dim):
    """The function of scripts/bench_cls_split_attention.py::cls_split_attention
    rebuilt on the CPU (the script's kernel needs a TPU): the patch rows as
    its _cls_kernel computes them (scores times the scale, exp, the cls key
    merged as a rank-1 term) and the cls row through jax.nn.softmax."""
    import jax

    scale = true_head_dim ** -0.5
    qc, qp = q[:, :, :1], q[:, :, 1:]
    kc, kp = k[:, :, :1], k[:, :, 1:]
    vc, vp = v[:, :, :1], v[:, :, 1:]
    scores = jnp.einsum("bhqd,bhkd->bhqk", qp, kp) * scale
    s_c = jnp.sum(qp * kc, axis=-1, keepdims=True) * scale
    m = jnp.maximum(jnp.max(scores, axis=-1, keepdims=True), s_c)
    p = jnp.exp(scores - m)
    e_c = jnp.exp(s_c - m)
    out_p = (jnp.einsum("bhqk,bhkd->bhqd", p, vp) + e_c * vc) / (
        jnp.sum(p, axis=-1, keepdims=True) + e_c)
    w = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", qc, k) * scale, axis=-1)
    out_c = jnp.einsum("bhqk,bhkd->bhqd", w, v)
    return jnp.concatenate([out_c, out_p], axis=2)


def test_cls_split_attention_scaled_matches_jax_script():
    rng = np.random.RandomState(5)
    b, h, n, d = 2, 3, 64, 8
    q, k, v = (rng.randn(b, h, 1 + n, d).astype(np.float32) for _ in range(3))
    want = np.asarray(_jax_cls_split_scaled(*(jnp.asarray(a) for a in (q, k, v)), d))
    got = TF.cls_split_attention_scaled(_t(q), _t(k), _t(v), d).numpy()
    assert got.shape == (b, h, 1 + n, d)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the cls row of the CUDA path (exp2 with the scale folded into the
    # scores) computes the same row
    scale_log2 = d ** -0.5 * TF.CLS_SPLIT_Q_PREMUL_LOG2E
    row = TF._cls_query_row(*(_t(a) for a in (q[:, :, :1], k[:, :, 1:], v[:, :, 1:],
                                              k[:, :, :1], v[:, :, :1])), scale_log2)
    np.testing.assert_allclose(row.numpy(), want[:, :, :1], atol=1e-5)


def test_cls_split_attention_concatenated_matches_jax():
    rng = np.random.RandomState(6)
    parts = [rng.randn(2, 2, s, 8).astype(np.float32) for s in (64, 64, 64, 1, 1, 1)]
    want = np.asarray(JF.cls_split_attention(*(jnp.asarray(a) for a in parts)))
    got = TF.cls_split_attention(*(_t(a) for a in parts)).numpy()
    assert got.shape == (2, 2, 65, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_attention_wrappers_count_no_launch_on_cpu():
    x = torch.randn(1, 65, 2, 8)
    counters = (TF.flash_attention, TF.cls_split_attention_scaled)
    before = [c.launches for c in counters]
    TF.flash_attention(x, x, x, causal=True)
    TF.builtin_flash_attention(x, x, x)
    TF.builtin_flash_attention_bhsd(x, x, x, 8)
    TF.cls_split_attention_scaled(x, x, x, 8)
    assert [c.launches for c in counters] == before
