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
