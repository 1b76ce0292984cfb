"""Port parity: the plain version of the cls query row that the cls-split CUDA
kernel computes (``_cls_query_row`` of certifiedgpt_tpu_torch/ops/flash_attention.py)
against the JAX package's ``cls_split_attention_parts`` on the CPU and against
the port's own plain cls-split attention, and the CPU behaviour of the two
cls-split wrappers (the plain versions, no launch).

Tolerances: f32 inputs 1e-5 (summation order only); bf16 inputs 2e-2 absolute
against f32 attention on the same rounded inputs (the row rounds its softmax
weights and its output to bf16)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.ops import flash_attention as JF
from certifiedgpt_tpu_torch.ops import flash_attention as TF


def _parts(n, d, dtype, seed):
    """qp, kp, vp [B, H, N, D] and qc, kc, vc [B, H, 1, D] from a numpy seed,
    q pre-scaled by d**-0.5 * log2(e), rounded to ``dtype``."""
    rng = np.random.RandomState(seed)
    b, h = 2, 3
    prem = (d ** -0.5) * TF.CLS_SPLIT_Q_PREMUL_LOG2E
    out = []
    for s, is_q in ((n, True), (n, False), (n, False), (1, True), (1, False), (1, False)):
        a = rng.randn(b, h, s, d).astype(np.float32) * (prem if is_q else 1.0)
        out.append(torch.from_numpy(a).to(dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale_log2", [1.0, 0.37], ids=["prescaled", "explicit_scale"])
@pytest.mark.parametrize("d", [8, 88])
@pytest.mark.parametrize("n", [64, 192])
def test_cls_query_row_matches_jax_and_plain(n, d, scale_log2, dtype):
    qp, kp, vp, qc, kc, vc = _parts(n, d, dtype, seed=n + d)
    row = TF._cls_query_row(qc, kp, vp, kc, vc, scale_log2)
    assert row.shape == (2, 3, 1, d) and row.dtype == dtype
    # the explicit scale multiplies every score: the same function as
    # pre-scaled queries times that factor, in f32 on the same rounded inputs
    f32 = [qp.float() * scale_log2, kp.float(), vp.float(),
           qc.float() * scale_log2, kc.float(), vc.float()]
    want_jax, _ = JF.cls_split_attention_parts(*(jnp.asarray(t.numpy()) for t in f32))
    want_plain, _ = TF._cls_split_attention_plain(*f32)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(row.float().numpy(), np.asarray(want_jax), atol=atol)
    np.testing.assert_allclose(row.float().numpy(), want_plain.numpy(), atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cls_split_wrappers_take_plain_versions_on_cpu(dtype):
    """On CPU tensors both wrappers return exactly what their plain versions
    return, launch nothing, and do not call the plain cls row either."""
    parts = _parts(64, 8, dtype, seed=7)
    counters = (TF.cls_split_attention_parts, TF.cls_split_attention_scaled, TF.flash_attention)
    before = [c.launches for c in counters]
    rows_before = TF._cls_query_row.calls
    out_c, out_p = TF.cls_split_attention_parts(*parts)
    ref_c, ref_p = TF._cls_split_attention_plain(*parts)
    assert torch.equal(out_c, ref_c) and torch.equal(out_p, ref_p)
    assert out_c.shape == (2, 3, 1, 8) and out_p.shape == (2, 3, 64, 8)
    q, k, v = (torch.cat([c, p], dim=2) for c, p in zip(parts[3:], parts[:3]))
    got = TF.cls_split_attention_scaled(q, k, v, 8)
    assert torch.equal(got, TF._cls_split_attention_scaled_plain(q, k, v, 8 ** -0.5))
    assert got.shape == (2, 3, 65, 8)
    assert [c.launches for c in counters] == before
    assert TF._cls_query_row.calls == rows_before
    assert math.isclose(TF.CLS_SPLIT_Q_PREMUL_LOG2E, math.log2(math.e))
