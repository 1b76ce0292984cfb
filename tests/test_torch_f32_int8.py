"""Port parity for the f32 int8 paths and the int8-KV kernels' routing on the
CPU: the routing function ``ops/attention.py::kv8_kernel``; a plain
emulation of the three-term bf16 split that the f32 instances of
``csrc/int8_weight_matmul.cu`` and ``csrc/attention_kv8.cu`` multiply with,
and of the weight-only product built on it, against JAX's f32 einsum; the
f32 prefill's plain path (``prefill_attention_kv8``) against the JAX
sequence (``quantize_rows``, ``dynamic_update_slice``,
``multi_head_attention_kv8``), cache bit for bit; and
``multi_head_attention_kv8`` of lone query rows at the group sizes that
route to the decode kernel and to the tiled kernel, against the JAX
function."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from certifiedgpt_tpu.ops import attention as JA
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.ops import attention as TA
from certifiedgpt_tpu_torch.ops import quantization as TQ

# f32 outputs within 1e-5 relative (Frobenius) of the JAX function (the f32
# sums' order), bf16 within 1e-2 (p rounds to bf16 in both)
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the emulated three-term product against JAX's f32 einsum
PRODUCT_REL_TOL = 1e-6
NAMES = ("k", "v", "k_scale", "v_scale")
TOP16 = np.uint32(0xFFFF0000)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def split3(x):
    """The kernels' three-term split of f32 ``x``, emulated: hi = x truncated
    to bf16 (the low 16 bits masked off), mid = (x - hi) truncated, lo =
    x - hi - mid truncated; an infinite x is its own hi (the rest 0)."""
    x = np.asarray(x, np.float32)
    hi = (_bits(x) & TOP16).view(np.float32)
    with np.errstate(invalid="ignore"):
        r = np.where(hi == x, np.float32(0), x - hi).astype(np.float32)
    mid = (_bits(r) & TOP16).view(np.float32)
    lo = (_bits(r - mid) & TOP16).view(np.float32)
    return hi, mid, lo


def _values(rng, n):
    """Random normal values, large ones near the top of the f32 range, tiny
    normal ones down to 2^-110 and random exponents in between."""
    return np.concatenate([
        rng.randn(n), rng.uniform(1, 3.4, n) * 1e38 * rng.choice([-1, 1], n),
        rng.uniform(1, 2, n) * 2.0 ** -110 * rng.choice([-1, 1], n),
        rng.randn(n) * 2.0 ** rng.randint(-100, 100, n),
    ]).astype(np.float32)


# ----------------------------------------------------------------------
# the routing function
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("writes", [False, True], ids=["bare", "writes"])
def test_kv8_kernel_routes_every_case(dtype, writes):
    """Every (rows, head width, group) a wrapper can see: bf16 rows of
    several queries at head_dim 128 take the prefill kernel, a lone row at
    a group of ``KV8_DECODE_GROUPS`` the decode kernel, the rest (f32 rows
    of several queries, other head widths, other groups) the tiled
    kernel, with and without rows to write."""
    for rows, dh, g in itertools.product((1, 2, 7, 96, 320), range(16, 257, 16),
                                         (1, 2, 3, 4, 5, 6, 8, 16)):
        got = TA.kv8_kernel(dtype, rows, dh, g, writes)
        if dtype == torch.bfloat16 and rows > 1 and dh == 128:
            want = "prefill"
        elif rows == 1 and g in (1, 2, 4, 8):
            want = "decode"
        else:
            want = "tiled"
        assert got == want, (rows, dh, g)
    assert TA.KV8_DECODE_GROUPS == (1, 2, 4, 8)
    assert TA.kv8_kernel(dtype, 96, 128, 1, writes) == (
        "prefill" if dtype == torch.bfloat16 else "tiled")


# ----------------------------------------------------------------------
# the three-term split and the weight-only product built on it
# ----------------------------------------------------------------------
def test_split3_sums_back_bit_for_bit():
    """hi + mid + lo is x bit for bit on random, large and tiny normal
    values (|x| >= 2^-110), each term a bf16 value (its low 16 bits zero)
    no larger than x; zeros of both signs split into zeros (hi keeps the
    sign); an infinite x is hi, with mid = lo = 0."""
    x = _values(np.random.RandomState(0), 4096)
    hi, mid, lo = split3(x)
    for term in (hi, mid, lo):
        assert not (_bits(term) & np.uint32(0xFFFF)).any()
        assert (np.abs(term) <= np.abs(x)).all()
    total = (hi + mid) + lo
    np.testing.assert_array_equal(_bits(total), _bits(x))
    zeros = np.array([0.0, -0.0], np.float32)
    hz, mz, lz = split3(zeros)
    np.testing.assert_array_equal(_bits(hz), _bits(zeros))
    assert not mz.any() and not lz.any()
    inf = np.array([np.inf, -np.inf], np.float32)
    hi_inf, mid_inf, lo_inf = split3(inf)
    np.testing.assert_array_equal(hi_inf, inf)
    assert not mid_inf.any() and not lo_inf.any()


def test_split3_at_the_subnormal_edge():
    """Below |x| = 2^-110 the lo term lies among bf16's subnormals: the sum
    loses what lies under 2^-133 and no more (|x - sum| < 2^-133), down to
    f32's own subnormals; at and above 2^-110 it is exact."""
    rng = np.random.RandomState(1)
    e = rng.randint(-149, -109, 4096)
    x = (rng.uniform(1, 2, 4096) * 2.0 ** e * rng.choice([-1, 1], 4096)).astype(np.float32)
    hi, mid, lo = split3(x)
    err = np.abs(x.astype(np.float64) - (hi.astype(np.float64) + mid + lo))
    assert (err < 2.0 ** -133).all()
    exact = np.abs(x) >= 2.0 ** -110
    assert exact.any() and not err[exact].any()
    assert err[~exact].any()  # the edge is real: some bits are lost below it


def _emulated_product(x, kq, scale):
    """The f32 instance's arithmetic: each 16-wide K step's products of
    x's three terms and the int8 weights summed from zero (exact here, in
    f64), rounded to f32 and added to the f32 accumulator; then times the
    channel scale in f32."""
    terms = split3(x)
    acc = np.zeros((x.shape[0], kq.shape[1]), np.float32)
    w = kq.astype(np.float64)
    for k0 in range(0, x.shape[1], 16):
        part = sum(t[:, k0:k0 + 16].astype(np.float64) @ w[k0:k0 + 16] for t in terms)
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return (acc * scale).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(1, 64, 24), (3, 256, 40), (9, 1024, 16)])
def test_emulated_f32_product_matches_jax(m, k, n):
    """The emulated product within 1e-6 relative of JAX's weight-only dense
    at f32 (``einsum(x, kernel_q.astype(f32), preferred_element_type=f32) *
    scale``), and the port's plain version too."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    kq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.rand(n) * 1e-2).astype(np.float32)
    want = np.asarray(jnp.einsum("...i,io->...o", jnp.asarray(x),
                                 jnp.asarray(kq).astype(jnp.float32),
                                 preferred_element_type=jnp.float32) * jnp.asarray(scale))
    assert _rel(_emulated_product(x, kq, scale), want) < PRODUCT_REL_TOL
    plain = TQ.int8_weight_forward(torch.from_numpy(x), torch.from_numpy(kq),
                                   torch.from_numpy(scale))
    assert _rel(plain.numpy(), want) < PRODUCT_REL_TOL


# ----------------------------------------------------------------------
# the f32 prefill and lone query rows
# ----------------------------------------------------------------------
def _old_cache(rng, b, t, h_kv, dh):
    k = JQ.quantize_rows(jnp.asarray(rng.randn(b, t, h_kv, dh).astype(np.float32) * 2))
    v = JQ.quantize_rows(jnp.asarray(rng.randn(b, t, h_kv, dh).astype(np.float32)))
    return dict(zip(("k", "k_scale", "v", "v_scale"), (np.asarray(a) for a in (*k, *v))))


def _mask(b, s, t, offset):
    """Query i at slot offset + i sees the slots up to its own; row 0
    left-padded by two slots, the last batch row fully masked."""
    valid = np.ones((b, t), bool)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    causal = np.arange(t)[None, :] <= offset + np.arange(s)[:, None]
    return causal[None, None] & valid[:, None, None, :]


@pytest.mark.parametrize("b,s,t,h,h_kv,dh,offset", [
    (2, 5, 12, 4, 4, 16, 3),  # the tiny configuration's head shape
    (3, 7, 40, 6, 2, 16, 30),  # three query heads a kv head, the new rows last
    (2, 9, 70, 4, 4, 64, 0),  # another head width, a cache past two 32-slot tiles
    (1, 1, 9, 8, 1, 32, 4),  # one new row, eight query heads a kv head
])
def test_f32_prefill_plain_matches_jax(b, s, t, h, h_kv, dh, offset):
    """The f32 prefill's plain version (what the tiled kernel is held to on
    the card): the cache's codes and scales bit for bit the JAX sequence's,
    the output within 1e-5 relative, a fully masked row zeros; no kernel
    counter moves on the CPU."""
    rng = np.random.RandomState(7 * t + s + dh)
    old = _old_cache(rng, b, t, h_kv, dh)
    q, k, v = (rng.randn(b, s, n, dh).astype(np.float32) * sc
               for n, sc in ((h, 1.0), (h_kv, 3.0), (h_kv, 1.0)))
    mask = _mask(b, s, t, offset)
    kq, ks = JQ.quantize_rows(jnp.asarray(k))
    vq, vs = JQ.quantize_rows(jnp.asarray(v))
    jcache = {name: lax.dynamic_update_slice(jnp.asarray(old[name]), upd, (0, offset, 0, 0))
              for name, upd in zip(NAMES, (kq, vq, ks, vs))}
    want = np.asarray(JA.multi_head_attention_kv8(
        jnp.asarray(q), jcache["k"], jcache["k_scale"], jcache["v"], jcache["v_scale"],
        jnp.asarray(mask)))
    cache = {name: torch.from_numpy(old[name].copy()) for name in NAMES}
    counters = (TA.multi_head_attention_kv8, TA.prefill_attention_kv8, TA.decode_attention_kv8)
    before = [c.launches for c in counters]
    got = TA.prefill_attention_kv8(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), cache, offset, torch.from_numpy(mask))
    assert [c.launches for c in counters] == before
    for name in NAMES:
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]),
                                      err_msg=name)
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) < REL_TOL["float32"]
    if b > 1:
        assert not got[-1].numpy().any()


@pytest.mark.parametrize("g", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lone_row_matches_jax(g, dtype):
    """``multi_head_attention_kv8`` of a lone query row (the decode kernel's
    case at g 1, 2 and 8 on the card, the tiled kernel's at g 3) against
    the JAX function within the tolerance of its dtype; the cache is left
    as it was; a fully masked row gives zeros."""
    rng = np.random.RandomState(g)
    b, t, h_kv, dh = 3, 21, 2, 16
    old = _old_cache(rng, b, t, h_kv, dh)
    jq = jnp.asarray(rng.randn(b, 1, h_kv * g, dh).astype(np.float32)).astype(dtype)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32)))
    tq = tq.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    mask = _mask(b, 1, t, t - 3)
    want = np.asarray(JA.multi_head_attention_kv8(
        jq, jnp.asarray(old["k"]), jnp.asarray(old["k_scale"]), jnp.asarray(old["v"]),
        jnp.asarray(old["v_scale"]), jnp.asarray(mask)).astype(jnp.float32))
    cache = {name: torch.from_numpy(old[name].copy()) for name in NAMES}
    got = TA.multi_head_attention_kv8(tq, cache["k"], cache["k_scale"], cache["v"],
                                      cache["v_scale"], torch.from_numpy(mask))
    for name in NAMES:
        np.testing.assert_array_equal(cache[name].numpy(), old[name], err_msg=name)
    assert got.dtype == tq.dtype and got.shape == (b, 1, h_kv * g, dh)
    got = got.float().numpy()
    assert _rel(got, want) < REL_TOL[dtype]
    assert not got[-1].any()
    kernel = TA.kv8_kernel(tq.dtype, 1, dh, g, False)
    assert kernel == ("tiled" if g == 3 else "decode")
