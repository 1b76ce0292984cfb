"""The row-quant kernels' arithmetic on the CPU (csrc/row_quant.cu runs only
on a GPU: tests/test_torch_kernels_gpu.py and ``python3 chip_smoke.py`` hold
it against the plain versions there).

- ``_gelu_quant_rows_as_plain``, the GELU kernel's function in plain
  PyTorch (the TPU kernel's A-S erf), against the JAX Pallas kernel in
  interpret mode;
- a numpy twin of the kernels' division-free rounding (``code_fast`` and
  ``code_exact`` in row_quant.cu) against the exact quotient, over every
  finite bf16 value and a few hundred row scales;
- the wrappers' operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.ops import quantization as TQ

# row_quant.cu: kRoundMagic, kNearHalf
ROUND_MAGIC = np.float32(1.5 * 2 ** 23)
NEAR_HALF = np.float32(0.5 - 2.0 ** -14)


def _codes_twin(h: np.ndarray, xs: np.float32):
    """The kernels' codes of f32 values ``h`` at scale ``xs``, f32 step by
    step: ``t = h * (1 / xs)`` rounded through ``t + 1.5 * 2^23`` (the code is
    that sum's low byte); within 2^-14 of a half-integer, the exact quotient
    instead. Returns (codes, how many took the exact quotient)."""
    one = np.float32(1.0)
    inv = one / xs
    t = h * inv
    u = t + ROUND_MAGIC
    near = np.abs(t - (u - ROUND_MAGIC)) > NEAR_HALF
    fast = (u.view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)
    exact = np.clip(np.rint(h / xs), -127, 127).astype(np.int8)
    return np.where(near, exact, fast), int(near.sum())


def _finite_bf16() -> np.ndarray:
    """Every finite bf16 value, as f32."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return bits[np.isfinite(bits)]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _row_scales() -> np.ndarray:
    """Row absmaxes: 300 bf16 values spread log-uniformly over 1e-12 .. 1e30,
    and the special ones (scale 1, the 1e-8 floor and around it, the
    largest bf16)."""
    rng = np.random.RandomState(0)
    spread = _bf16(10.0 ** rng.uniform(-12, 30, size=300))
    special = _bf16([127.0, 1.0, 1e-8, 9e-9, 2e-8, 3.3895e38, 0.0])
    return np.unique(np.concatenate([spread, special]))


def test_division_free_rounding_equals_exact_quotient():
    """Codes equal clip(rint(h / xs)) bit for bit for every finite bf16 h
    that a row of absmax A can hold (|h| <= A), xs = max(A, 1e-8) / 127,
    over a few hundred A; the exact-quotient path is taken and needed."""
    values = _finite_bf16()
    slow, mismatched_fast = 0, 0
    for amax in _row_scales():
        xs = np.maximum(np.float32(amax), np.float32(1e-8)) / np.float32(127.0)
        h = values[np.abs(values) <= amax]
        got, n_near = _codes_twin(h, xs)
        want = np.clip(np.round(h / xs), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(got, want, err_msg=f"absmax {amax!r}")
        slow += n_near
        t = h * (np.float32(1.0) / xs)
        mismatched_fast += int((np.rint(t) != np.round(h / xs)).sum())
    assert slow > 0
    # the fast rounding alone would be wrong somewhere: the check is needed
    assert mismatched_fast > 0


@pytest.mark.parametrize("h,code", [(63.5, 64), (-0.5, 0), (127.0, 127), (2.5, 2),
                                    (-63.5, -64), (0.5, 0), (1.5, 2), (-126.5, -126)])
def test_exact_ties_at_scale_one(h, code):
    """A row of absmax 127 has the scale 1: its exact halves round to even."""
    xs = np.float32(127.0) / np.float32(127.0)
    got, _ = _codes_twin(np.array([h], np.float32), xs)
    assert int(got[0]) == code
    # the plain versions' quantization agrees
    q, s = TQ._quantize_rows_plain(torch.tensor([[h, 127.0]]))
    assert int(q[0, 0]) == code and float(s[0, 0]) == 1.0


@pytest.mark.parametrize("std", [1.0, 3.0])
def test_gelu_as_plain_matches_pallas_kernel(std):
    """The A-S plain version against the TPU kernel's function (the Pallas
    kernel in interpret mode): codes one step apart on at most 1e-4 of the
    elements, scales within 1e-6 relative."""
    rng = np.random.RandomState(3)
    x = (rng.randn(256, 384) * std).astype(np.float32)
    x[5] = 0.0  # a row of zeros
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    jq, js = JQ.gelu_quant_rows(jx, interpret=True)
    tq, ts = TQ._gelu_quant_rows_as_plain(tx)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    diff = np.abs(np.asarray(jq).astype(np.int32) - tq.numpy().astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4
    assert not tq[5].any()


@pytest.mark.parametrize("k", [8, 24, 384, 1408])
def test_row_sums_in_kernel_order(k):
    """``_row_sums`` adds in the LayerNorm kernel's order: exact on values
    whose sum is exact in any order, and within f32 rounding otherwise."""
    rng = np.random.RandomState(k)
    ints = torch.from_numpy(rng.randint(-50, 50, size=(5, k)).astype(np.float32))
    assert torch.equal(TQ._row_sums(ints), ints.sum(dim=-1, keepdim=True))
    v = torch.from_numpy(rng.randn(5, k).astype(np.float32))
    torch.testing.assert_close(TQ._row_sums(v), v.double().sum(-1, keepdim=True).float(),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_a_misaligned_view():
    """The bulk copies need the rows on a 16-byte boundary: a view one
    element into a buffer is refused; the buffer itself passes."""
    buf = torch.zeros(4 * 16 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        TQ._check_rows(buf[1:65].view(4, 16), "gelu_quant_rows")
    assert TQ._check_rows(buf[8:72].view(4, 16), "gelu_quant_rows") == (4, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_params_read_in_their_dtype(dtype):
    x = torch.zeros(3, 16, dtype=torch.bfloat16)
    scale, bias = torch.ones(16, dtype=dtype), torch.zeros(16, dtype=torch.float32)
    g, g32, b, b32 = TQ._check_ln_params(scale, bias, x)
    assert g is scale and g32 == int(dtype == torch.float32) and b32 == 1


@pytest.mark.parametrize("case", ["float16", "float64", "shape"])
def test_ln_params_refused(case):
    x = torch.zeros(3, 16, dtype=torch.bfloat16)
    scale = torch.ones(16)
    if case == "shape":
        scale = torch.ones(8)
    elif case == "float16":
        scale = scale.half()
    else:
        scale = scale.double()
    with pytest.raises(ValueError if case == "shape" else TypeError):
        TQ._check_ln_params(scale, torch.zeros(16), x)
