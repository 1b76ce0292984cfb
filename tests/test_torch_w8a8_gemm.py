"""Port parity of the W8A8 product (certifiedgpt_tpu_torch/ops/quantization.py
``w8a8_product``: on the card one kernel, csrc/w8a8_gemm.cu, with the
rescale and the bias in its epilogue) on the CPU, where the wrapper takes
its plain version: against the JAX package's ``w8a8_matmul`` (through the
dense layer, bias included) and ``w8a8_gelu_matmul``, bit for bit wherever
the f32 sum of the int8 products stays below 2^24 (there it is exact in
both packages, and the rescale rounds in the same order); ``int8_accumulate``
exact against an int64 product; the straight-through gradient of
``w8a8_matmul``; the wrapper's refusals; and the row-parallel dense's
rescale (``int8_accumulate``, the sum over ranks, ``w8a8_epilogue``) bit
for bit the one-process product's. The kernel itself runs in
tests/test_torch_kernels_gpu.py on a GPU."""

import functools
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.ops import quantization as TQ
from certifiedgpt_tpu_torch.parallel import tensor_parallel as TP

ROWS = [1, 8, 17, 96]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and values."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)


def _case(seed, m, k, n, jdt):
    """Rows of x (N(0, 2^2)) in ``jdt`` and a quantized [k, n] kernel."""
    rng = np.random.RandomState(seed)
    jx = jnp.asarray(rng.randn(m, k).astype(np.float32) * 2).astype(jdt)
    q = JQ.quantize_kernel(jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.05))
    bias = rng.randn(n).astype(np.float32) * 0.1
    return jx, q, bias


def _exact(xq, kq) -> np.ndarray:
    """The int8 product summed in int64."""
    return np.asarray(xq, np.int64) @ np.asarray(kq, np.int64)


@functools.lru_cache(maxsize=None)
def _jax_dense(dtype, bias):
    """The JAX dense layer's W8A8 branch (``w8a8_matmul``, then the bias add
    in x's dtype) on 96 rows, with its row codes and kernel: the JAX side
    runs once, and each row count compares its leading rows (the codes, the
    scales and the exact sums are row by row)."""
    jdt = DTYPES[dtype][0]
    jx, q, b = _case(0, max(ROWS), 96, 40, jdt)
    params = {"kernel_q": q["kernel_q"], "scale": q["scale"]}
    if bias:
        params["bias"] = jnp.asarray(b).astype(jdt)
    want = JL.dense(params, jx, act_quant=True)
    jxq, jxs = JQ.quantize_rows(jx)
    assert np.abs(_exact(jxq, q["kernel_q"])).max() < 2 ** 24
    return jx, params, want, jxq, jxs


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_w8a8_product_matches_jax_dense(dtype, bias, m):
    """From the JAX package's own row codes, ``w8a8_product`` gives the JAX
    dense layer's W8A8 branch (``w8a8_matmul``, then the bias add in x's
    dtype) bit for bit; so does the port's dense through it."""
    tdt = DTYPES[dtype][1]
    jx, params, want, jxq, jxs = _jax_dense(dtype, bias)
    want = _jbits(want)[:m]
    kq = TQ.int8_kernel_layout(torch.from_numpy(np.array(params["kernel_q"])))
    sc = torch.from_numpy(np.array(params["scale"]))
    tb = _torch(params["bias"]) if bias else None
    got = TQ.w8a8_product(torch.from_numpy(np.array(jxq[:m])),
                          torch.from_numpy(np.array(jxs[:m])), kq, sc, tb, tdt)
    assert got.dtype == tdt and got.shape == (m, want.shape[1])
    np.testing.assert_array_equal(_bits(got), want)
    tparams = {"kernel_q": kq, "scale": sc, **({"bias": tb} if bias else {})}
    np.testing.assert_array_equal(_bits(TL.dense(tparams, _torch(jx[:m]), act_quant=True)),
                                  want)


@functools.lru_cache(maxsize=None)
def _jax_gelu(dtype):
    """``w8a8_gelu_matmul`` on 96 rows with its GELU row codes and kernel."""
    jdt = DTYPES[dtype][0]
    jx, q, _ = _case(1, max(ROWS), 64, 24, jdt)
    want = JQ.w8a8_gelu_matmul(jx, q["kernel_q"], q["scale"])
    jxq, jxs = JQ.gelu_quant_rows(jx)
    assert np.abs(_exact(jxq, q["kernel_q"])).max() < 2 ** 24
    return jx, q, want, jxq, jxs


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_w8a8_product_matches_jax_gelu_matmul(dtype, m):
    """From JAX's GELU row codes, ``w8a8_product`` gives ``w8a8_gelu_matmul``
    bit for bit; the port's ``w8a8_gelu_matmul`` is ``w8a8_product`` of its
    own GELU codes."""
    tdt = DTYPES[dtype][1]
    jx, q, want, jxq, jxs = _jax_gelu(dtype)
    kq = torch.from_numpy(np.array(q["kernel_q"]))
    sc = torch.from_numpy(np.array(q["scale"]))
    got = TQ.w8a8_product(torch.from_numpy(np.array(jxq[:m])),
                          torch.from_numpy(np.array(jxs[:m])), kq, sc, None, tdt)
    np.testing.assert_array_equal(_bits(got), _jbits(want)[:m])
    tx = _torch(jx[:m])
    codes = TQ.gelu_quant_rows(tx)
    np.testing.assert_array_equal(_bits(TQ.w8a8_gelu_matmul(tx, kq, sc)),
                                  _bits(TQ.w8a8_product(*codes, kq, sc, None, tdt)))


@pytest.mark.parametrize("m", [1, 17])
def test_int8_accumulate_is_exact_on_cpu(m):
    """``int8_accumulate`` on CPU tensors is the int64 product exactly, up to
    sums of +-127^2 x 1024 (below 2^24), as the kernel's int32 sums are on
    the card."""
    rng = np.random.RandomState(m)
    xq = rng.randint(-127, 128, (m, 1024)).astype(np.int8)
    kq = rng.randint(-127, 128, (1024, 32)).astype(np.int8)
    xq[0] = 127
    kq[:, 0] = 127  # the largest sum: 127^2 x 1024
    got = TQ.int8_accumulate(torch.from_numpy(xq), TQ.int8_kernel_layout(torch.from_numpy(kq)))
    want = _exact(xq, kq)
    assert want[0, 0] == 127 * 127 * 1024
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_w8a8_matmul_straight_through_gradient(dtype):
    """The backward of ``w8a8_matmul`` with a bias is the float product's,
    ``g @ (kernel_q * scale)^T`` in g's dtype, and the bias's gradient the
    sum of g, bit for bit as written; against ``jax.vjp`` of the JAX dense
    within f32 1e-5 / bf16 1e-2 relative (summation order, one rounding)."""
    jdt, tdt = DTYPES[dtype]
    jx, q, b = _case(7, 10, 64, 24, jdt)
    jb = jnp.asarray(b).astype(jdt)
    rng = np.random.RandomState(8)
    g = rng.randn(10, 24).astype(np.float32)
    kq = torch.from_numpy(np.array(q["kernel_q"]))
    sc = torch.from_numpy(np.array(q["scale"]))
    tx = _torch(jx).requires_grad_(True)
    tb = _torch(jb).requires_grad_(True)
    tg = torch.from_numpy(g).to(tdt)
    TQ.w8a8_matmul(tx, kq, sc, tb).backward(tg)
    w = (kq.float() * sc[None, :]).to(tdt)
    assert torch.equal(tx.grad, (tg @ w.t()).to(tdt))
    assert torch.equal(tb.grad, tg.sum(0).to(tdt))
    _, vjp = jax.vjp(lambda x, bb: JL.dense({"kernel_q": q["kernel_q"], "scale": q["scale"],
                                             "bias": bb}, x, act_quant=True), jx, jb)
    jgx, jgb = vjp(jnp.asarray(g).astype(jdt))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((tx.grad, jgx), (tb.grad, jgb)):
        want = np.asarray(want.astype(jnp.float32), np.float64)
        err = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
        assert err < tol


def test_w8a8_product_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper (and ``int8_accumulate``) launches nothing,
    and ``_w8a8_epilogue`` (the dense layer's path) goes through
    ``w8a8_product``."""
    before = TQ.w8a8_product.launches
    xq = torch.ones(3, 32, dtype=torch.int8)
    kq = TQ.int8_kernel_layout(torch.ones(32, 8, dtype=torch.int8))
    TQ.w8a8_product(xq, torch.ones(3, 1), kq, torch.ones(8))
    TQ.int8_accumulate(xq, kq)
    assert TQ.w8a8_product.launches == before
    with mock.patch.object(TQ, "w8a8_product", wraps=TQ.w8a8_product) as spy:
        out = TQ._w8a8_epilogue(xq.reshape(1, 3, 32), torch.ones(1, 3, 1), kq, torch.ones(8),
                                torch.bfloat16)
    assert spy.call_count == 1 and out.shape == (1, 3, 8)
    assert bool((out == 32).all())


@pytest.mark.parametrize("what", ["k_not_16", "n_not_8", "row_major", "not_int8"])
def test_w8a8_kernel_refuses_what_it_does_not_take(what):
    """The launcher's checks raise before any launch: K a multiple of 16, N
    of 8, the kernel column-major, int8 operands."""
    k, n = {"k_not_16": (40, 8), "n_not_8": (32, 12)}.get(what, (32, 8))
    xq = torch.zeros(4, k, dtype=torch.int8)
    kq = TQ.int8_kernel_layout(torch.zeros(k, n, dtype=torch.int8))
    if what == "row_major":
        kq = kq.contiguous()
    if what == "not_int8":
        xq = xq.int()
    out = torch.empty(4, n, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        TQ._launch_w8a8_gemm(xq, kq, None, None, None, out, TQ._OUT_BF16)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_row_parallel_rescale_is_the_one_process_product(dtype, bias):
    """The row-parallel dense's W8A8 path on one rank (its collectives the
    identity) is the dense layer's product bit for bit; and the sums of two
    halves of K, added as two ranks' partials are, rescaled by
    ``w8a8_epilogue``, are ``w8a8_product`` bit for bit."""
    jdt, tdt = DTYPES[dtype]
    jx, q, b = _case(11, 9, 64, 16, jdt)
    kq = TQ.int8_kernel_layout(torch.from_numpy(np.array(q["kernel_q"])))
    sc = torch.from_numpy(np.array(q["scale"]))
    params = {"kernel_q": kq, "scale": sc}
    if bias:
        params["bias"] = torch.from_numpy(b).to(tdt)
    x = _torch(jx)
    mesh = SimpleNamespace(model_group=None)
    with mock.patch.object(TP.dist, "all_reduce", lambda *args, **kwargs: None):
        got = TP.row_parallel_dense(params, x, mesh, act_quant=True)
    np.testing.assert_array_equal(_bits(got), _bits(TL.dense(params, x, act_quant=True)))
    xq, xs = TQ.quantize_rows(x)
    acc = TQ.int8_accumulate(xq[:, :32], kq[:32]) + TQ.int8_accumulate(xq[:, 32:], kq[32:])
    np.testing.assert_array_equal(
        _bits(TQ.w8a8_epilogue(acc, xs, sc, params.get("bias"), tdt)),
        _bits(TQ.w8a8_product(xq, xs, kq, sc, params.get("bias"), tdt)))


@functools.lru_cache(maxsize=None)
def _jax_dense_split(dtype):
    """The JAX dense layer's W8A8 branch with a bias at K = 6144 (the ViT's
    fc2 depth, where the kernel splits K below 129 rows) on 128 rows and a
    small N, with its row codes."""
    jdt = DTYPES[dtype][0]
    jx, q, b = _case(22, 128, 6144, 24, jdt)
    params = {"kernel_q": q["kernel_q"], "scale": q["scale"], "bias": jnp.asarray(b).astype(jdt)}
    want = JL.dense(params, jx, act_quant=True)
    jxq, jxs = JQ.quantize_rows(jx)
    assert np.abs(_exact(jxq, q["kernel_q"])).max() < 2 ** 24
    return params, want, jxq, jxs


@pytest.mark.parametrize("m", [1, 96, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_w8a8_product_matches_jax_dense_at_split_k_shapes(dtype, m):
    """At the row counts whose K the kernel splits (a caption's 1, the cls
    stream's 96, a whole row tile of 128) and K = 6144, ``w8a8_product``'s
    plain version is the JAX dense layer's W8A8 branch bit for bit."""
    tdt = DTYPES[dtype][1]
    params, want, jxq, jxs = _jax_dense_split(dtype)
    got = TQ.w8a8_product(torch.from_numpy(np.array(jxq[:m])),
                          torch.from_numpy(np.array(jxs[:m])),
                          TQ.int8_kernel_layout(torch.from_numpy(np.array(params["kernel_q"]))),
                          torch.from_numpy(np.array(params["scale"])), _torch(params["bias"]),
                          tdt)
    np.testing.assert_array_equal(_bits(got), _jbits(want)[:m])


@pytest.mark.parametrize("m,n,k,splits", [
    (96, 1408, 1408, 1), (96, 4224, 1408, 1), (96, 6144, 1408, 1), (96, 1408, 6144, 6),
    (8, 4224, 1408, 1), (8, 4224, 6144, 2), (1, 6144, 1408, 1), (1, 1408, 6144, 6),
    (128, 1408, 6144, 6), (129, 1408, 6144, 1), (98304, 4224, 1408, 1), (1, 8, 16, 1),
    (96, 4096, 11008, 2), (1, 64, 1408, 1), (1, 64, 11008, 10)])
def test_w8a8_splits_at_the_path_shapes(m, n, k, splits):
    """The K splits the launcher asks for on a 132-SM H100: none above one
    row tile, none below 16 K steps (the cls stream's K = 1408 products);
    at K = 6144 (the cls stream's fc2, eval's and a caption's) as many as
    give the card's SMs a (channel tile, split) unit each, 8 K steps or
    more a split."""
    assert TQ.w8a8_splits(m, n, k, 132) == splits


def test_w8a8_splits_fit_the_scratch():
    """Over many shapes and SM counts, a split launch's units (channel
    tiles x splits) fit the scratch's SM-count units, every split keeps K
    steps of its own (8 or more), and the scratch holds each unit's 128 x
    64 partial sums and a counter a tile."""
    rows, width = TQ.W8A8_SPLIT_TILE
    assert TQ.w8a8_scratch_ints(132) == 132 * (rows * width + 1)
    for sms in (1, 7, 78, 114, 132):
        for m in (1, 8, 96, 128, 129, 4096):
            for n in (8, 64, 200, 1408, 4224, 6144, 11008, 50000):
                for k in (16, 128, 144, 1408, 4112, 6144, 11008):
                    splits = TQ.w8a8_splits(m, n, k, sms)
                    steps = -(-k // TQ.W8A8_BLOCK_K)
                    assert 1 <= splits <= steps
                    per = -(-steps // splits)
                    assert (splits - 1) * per < steps  # the last split has steps too
                    assert splits == 1 or per >= TQ.W8A8_SPLIT_MIN_STEPS
                    if m > rows:
                        assert splits == 1
                    if splits > 1:
                        tiles = -(-n // width)
                        assert tiles * splits <= sms
