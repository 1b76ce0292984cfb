"""Int8 quantization: weight-only, W8A8 and the fused row-quant kernels.

Port of ``certifiedgpt_tpu/ops/quantization.py``. Layout as there: a
quantized dense leaf is ``{"kernel_q": int8 [in, out], "scale": f32 [out]}``
(stacked layers: ``[L, in, out]`` / ``[L, out]``). Quantization is
symmetric, rounds half to even and clips to +-127.

Two of the repository's Pallas TPU kernels live here as hand-written CUDA
kernels (``csrc/row_quant.cu``): ``ln_quant_rows`` (LayerNorm + row quant)
and ``gelu_quant_rows`` (GELU + row quant). Each wrapper dispatches on the
tensor's device: a CPU tensor takes the plain PyTorch version next to it,
a CUDA tensor launches the kernel or raises. ``<wrapper>.launches`` counts
the kernel launches.

The W8A8 GEMM is a plain matrix product in the JAX package (an einsum
outside any kernel), so here it is ``torch._int_mm`` on CUDA (exact int32
accumulation; JAX accumulates in f32, exact below 2^24 and within one f32
ulp of the sum above it, so the two differ by less than 1e-7 relative
before the bf16 output rounding) and an f32 product of the int8 values on
the CPU (exact below 2^24). ``_int_mm`` takes the int8 kernel column-major
(``int8_kernel_layout``), which the model builders store.

``w8a8_matmul``, ``w8a8_gelu_matmul`` and the weight-only product
``int8_weight_matmul`` are ``torch.autograd.Function``s, differentiable in
their activation by the JAX package's straight-through estimators: the
backward multiplies by the dequantized weight and saves only the int8
kernel and its scale. The kernels and scales get no gradient.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops import cuda_kernels

#: widest row the row-quant kernels take (csrc/row_quant.cu kMaxRowWidth)
MAX_ROW_WIDTH = 8192

#: fewest rows ``torch._int_mm`` takes on CUDA (M > 16, a multiple of 8)
INT_MM_MIN_ROWS = 24


def ieee_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as one IEEE division on every device (on CUDA,
    PyTorch divides by a Python number as a product with its reciprocal)."""
    return a / torch.full_like(a, b)


def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] float kernel -> per-out-channel symmetric int8 (the scale's
    division by 127 an IEEE division on every device, as in the JAX
    package)."""
    w = kernel.float()
    scale = ieee_div(w.abs().amax(dim=0).clamp_min(1e-8), 127.0)
    q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def quantize_stacked_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[L, in, out] stacked float kernels -> per-(layer, out-channel) int8."""
    w32 = w.float()
    scale = ieee_div(w32.abs().amax(dim=1).clamp_min(1e-8), 127.0)
    q = torch.round(w32 / scale[:, None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization of ``x [..., K]``:
    ``(xq int8, xs f32 [..., 1])`` with ``x ~ xq * xs``. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    xs = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(x32 / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def int8_kernel_layout(kernel_q: torch.Tensor) -> torch.Tensor:
    """The same ``[..., in, out]`` int8 kernel stored column-major (each
    output channel's ``in`` values contiguous), the operand layout of
    ``torch._int_mm`` on CUDA. Values and shape are unchanged."""
    return kernel_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def int8_matmul(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8 @ kernel_q [K, N] int8`` accumulated exactly, as
    f32 ``[M, N]``. On CUDA, fewer than ``INT_MM_MIN_ROWS`` rows (a cls
    stream of a few images) are zero-padded to that many for
    ``torch._int_mm``, which needs M > 16."""
    if xq.device.type != "cuda":
        return xq.float() @ kernel_q.float()
    m, k = xq.shape
    n = kernel_q.shape[1]
    if k % 8 or n % 8:
        raise ValueError(
            f"torch._int_mm needs K, N multiples of 8; got K={k}, N={n}"
        )
    if kernel_q.stride(0) != 1:
        raise ValueError(
            "the int8 kernel must be column-major on CUDA "
            "(ops.quantization.int8_kernel_layout)"
        )
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq.contiguous(), kernel_q)[:m].float()


def w8a8_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """``x [..., in] @ int8 kernel [in, out]`` with dynamic per-row
    activation quant: ``(xq @ wq) * xs * ws`` in f32, cast to x's dtype.
    Differentiable in ``x`` by the straight-through estimator of the JAX
    package's ``custom_vjp`` (``_W8A8Matmul``)."""
    return _W8A8Matmul.apply(x, kernel_q, scale)


def _w8a8_epilogue(xq, xs, kernel_q, scale, dtype) -> torch.Tensor:
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q)
    acc = acc.reshape(*lead, -1)
    return (acc * xs * scale).to(dtype)


def w8a8_gelu_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """``gelu(x) @ int8 kernel`` with the gelu and the per-row activation
    quant fused (``gelu_quant_rows``). Differentiable in ``x``: the
    backward is ``(g @ w^T) * gelu'(x)`` (``_W8A8GeluMatmul``)."""
    return _W8A8GeluMatmul.apply(x, kernel_q, scale)


def _dequantized_t(kernel_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``(kernel_q * scale)^T`` as ``[out, in]`` in ``dtype``: the float
    weight that the straight-through backward multiplies by."""
    return (kernel_q.float() * scale[None, :]).to(dtype).t()


def _grad_input(g: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    """``g [..., out] @ (kernel_q * scale)^T`` in ``g``'s dtype, cast to
    ``dtype``: JAX's ``einsum("...o,io->...i", g, w)``."""
    return torch.matmul(g, _dequantized_t(kernel_q, scale, g.dtype)).to(dtype)


class _W8A8Matmul(torch.autograd.Function):
    """The JAX package's ``w8a8_matmul`` ``custom_vjp``
    (certifiedgpt_tpu/ops/quantization.py:68-113). The forward quantizes
    the rows and runs the int8 product; the backward is the float
    product's, ``g @ (kernel_q * scale)^T``, so ``round``'s zero derivative
    never appears. Saved for the backward, as in JAX: the int8 kernel, its
    scale and x's dtype (no activation, no dequantized weight); the kernel
    and the scale get no gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale):
        ctx.save_for_backward(kernel_q, scale)
        ctx.x_dtype = x.dtype
        xq, xs = quantize_rows(x)
        return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        kernel_q, scale = ctx.saved_tensors
        return _grad_input(g, kernel_q, scale, ctx.x_dtype), None, None


class _W8A8GeluMatmul(torch.autograd.Function):
    """The JAX package's ``w8a8_gelu_matmul`` ``custom_vjp``
    (certifiedgpt_tpu/ops/quantization.py:308-345). The forward is the
    fused GELU + row quant (the CUDA kernel on the card) and the int8
    product; the backward is ``(g @ w^T) * (Phi(x) + x phi(x))`` with the
    exact erf (JAX's ``_w8a8_gelu_bwd``), not the kernel's A-S erf. Saved:
    x, the int8 kernel and its scale."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale):
        ctx.save_for_backward(x, kernel_q, scale)
        xq, xs = gelu_quant_rows(x)
        return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, kernel_q, scale = ctx.saved_tensors
        gh = _grad_input(g, kernel_q, scale, torch.float32)
        x32 = x.float()
        cdf = 0.5 * (1.0 + torch.erf(x32 * 2.0 ** -0.5))
        pdf = torch.exp(-0.5 * x32 * x32) * (1.0 / math.sqrt(2.0 * math.pi))
        return (gh * (cdf + x32 * pdf)).to(x.dtype), None, None


def int8_weight_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Weight-only int8 product ``(x @ kernel_q) * scale`` in x's dtype
    (the per-output-channel scale commutes with the contraction). Its
    backward saves only the int8 kernel and the scale and dequantizes when
    it runs (``_Int8WeightMatmul``): a saved float copy of every decoder
    kernel would hold gigabytes across a training step."""
    return _Int8WeightMatmul.apply(x, kernel_q, scale)


def _int8_weight_forward(x, kernel_q, scale):
    # on CUDA the bf16 copy of the int8 kernel is made on every call (a
    # plain-PyTorch cost the decode path pays; see ROADMAP.md)
    if x.device.type == "cuda" and x.dtype != torch.float32:
        acc = torch.matmul(x, kernel_q.to(x.dtype)).float()
    else:
        acc = torch.matmul(x.float(), kernel_q.float())
    return (acc * scale).to(x.dtype)


class _Int8WeightMatmul(torch.autograd.Function):
    """Weight-only int8 product with the gradient of the JAX package's
    ``(einsum(x, kernel_q.astype(x.dtype)) * scale).astype(x.dtype)``:
    ``gx = (g * scale) @ kernel_q^T`` in x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale):
        ctx.save_for_backward(kernel_q, scale)
        ctx.x_dtype = x.dtype
        return _int8_weight_forward(x, kernel_q, scale)

    @staticmethod
    def backward(ctx, g):
        kernel_q, scale = ctx.saved_tensors
        gs = g.float() * scale
        if g.device.type == "cuda" and ctx.x_dtype != torch.float32:
            gx = torch.matmul(gs.to(ctx.x_dtype), kernel_q.to(ctx.x_dtype).t())
        else:
            gx = torch.matmul(gs, kernel_q.float().t())
        return gx.to(ctx.x_dtype), None, None


# ----------------------------------------------------------------------
# fused row-quant kernels: plain versions and wrappers
# ----------------------------------------------------------------------
# Abramowitz-Stegun 7.1.26 erf, as the TPU kernel computes it
# (certifiedgpt_tpu/ops/quantization.py::_erf_approx)
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)

#: lanes of a warp and values of a piece in the LayerNorm kernel's sums
_LANES, _LN_PIECE = 32, 4


def _quantize_bf16_rows(h: torch.Tensor):
    """``quantize_rows`` of f32 rows ``h`` (already rounded through the
    activation dtype), the scale's division by 127 an IEEE division, as in
    the kernels."""
    amax = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    xs = ieee_div(amax, 127.0)
    return torch.round(h / xs).clamp(-127, 127).to(torch.int8), xs


def _gelu_quant_rows_plain(x: torch.Tensor):
    """``quantize_rows(gelu(x))``: exact-erf GELU in f32, rounded to x's
    dtype, then the per-row int8 quantization (the JAX package's chain off
    the TPU)."""
    return _quantize_bf16_rows(F.gelu(x.float()).to(x.dtype).float())


def _gelu_quant_rows_as_plain(x: torch.Tensor):
    """The GELU kernel's function in plain PyTorch: ``0.5 x (1 + erf(x /
    sqrt 2))`` with the TPU kernel's A-S erf, each step rounded in f32,
    rounded to x's dtype, then the per-row int8 quantization."""
    x32 = x.float()
    z = x32 * 2.0 ** -0.5
    az = z.abs()
    t = 1.0 / (1.0 + _AS_P * az)
    a1, a2, a3, a4, a5 = _AS_A
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return _quantize_bf16_rows((0.5 * x32 * (1.0 + erf)).to(x.dtype).float())


def _row_sums(v: torch.Tensor) -> torch.Tensor:
    """Row sums of ``v [M, K]`` (f32) in the LayerNorm kernel's order: lane
    ``l`` takes the pieces of ``_LN_PIECE`` values ``l, l + 32, ...`` and
    keeps one sum per position in a piece, added in piece order; a lane's
    four sums are added pairwise, then the lanes by a butterfly."""
    m, k = v.shape
    width = _LANES * _LN_PIECE
    v = F.pad(v, (0, -k % width)).reshape(m, -1, _LANES, _LN_PIECE)
    acc = torch.zeros_like(v[:, 0])
    for i in range(v.shape[1]):
        acc = acc + v[:, i]
    s = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    lane = torch.arange(_LANES, device=v.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, :1]


def _ln_quant_rows_plain(x, scale, bias, eps):
    """``quantize_rows(layer_norm(x))``: f32 LayerNorm with affine, rounded
    to x's dtype (the JAX package's ``_ln_chain_xla``). The mean and the
    variance are summed in the kernel's order and ``1 / sqrt(var + eps)``
    is rounded once, so on the card the kernel gives the same bits."""
    x32 = x.float().reshape(-1, x.shape[-1])
    k = x32.shape[-1]
    mean = ieee_div(_row_sums(x32), k)
    d = x32 - mean
    var = ieee_div(_row_sums(d * d), k)
    rs = 1.0 / torch.sqrt(var + eps)
    out = (d * rs) * scale.float() + bias.float()
    xq, xs = _quantize_bf16_rows(out.to(x.dtype).float())
    return xq.reshape(x.shape), xs.reshape(*x.shape[:-1], 1)


def _check_rows(x: torch.Tensor, name: str) -> Tuple[int, int]:
    """Rows the kernels take: bf16, a width that is a multiple of 8 up to
    ``MAX_ROW_WIDTH``, the first row on a 16-byte boundary (the bulk copies'
    alignment; the width then keeps every row there)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
    k = x.shape[-1]
    if k % 8 or k > MAX_ROW_WIDTH:
        raise ValueError(
            f"{name}: row width {k} must be a multiple of 8 and at most "
            f"{MAX_ROW_WIDTH}"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the rows must start on a 16-byte boundary")
    return x.numel() // k, k


def _check_ln_params(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor):
    """gamma and beta as the kernel reads them: ``[K]`` on x's device, each
    bf16 or f32, contiguous. Returns them with their ``is f32`` flags."""
    k = x.shape[-1]
    out = []
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (k,):
            raise ValueError(f"ln_quant_rows: {name} must be [{k}], got {tuple(p.shape)}")
        if p.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"ln_quant_rows: {name} must be bf16 or f32, got {p.dtype}")
        if p.device != x.device:
            raise ValueError(f"ln_quant_rows: {name} is on {p.device}, x on {x.device}")
        p = p.contiguous()
        out += [p, int(p.dtype == torch.float32)]
    return out


def _device_kind(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return kind


def _row_outputs(x: torch.Tensor):
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    return xq, xs


def gelu_quant_rows(x: torch.Tensor):
    """``quantize_rows(gelu(x))`` in one pass over device memory.

    Replaces ``_gelu_quant_kernel`` (certifiedgpt_tpu/ops/quantization.py
    :136). CPU tensors take ``_gelu_quant_rows_plain`` (the exact erf, as
    the JAX package computes off the TPU); bf16 CUDA tensors launch
    ``gelu_quant_kernel`` (csrc/row_quant.cu), whose function is
    ``_gelu_quant_rows_as_plain`` (the TPU kernel's A-S erf)."""
    if _device_kind(x) == "cpu":
        return _gelu_quant_rows_plain(x)
    x2 = x.contiguous()
    m, k = _check_rows(x2, "gelu_quant_rows")
    xq, xs = _row_outputs(x)
    if m == 0:
        return xq, xs
    code = cuda_kernels.build().lib.cgpt_gelu_quant(
        x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
        cuda_kernels.stream_of(x),
    )
    gelu_quant_rows.launches += 1
    cuda_kernels.check(code, "gelu_quant_rows")
    return xq, xs


gelu_quant_rows.launches = 0


def ln_quant_rows(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
):
    """``quantize_rows(layer_norm(x))`` in one pass over device memory.

    Replaces ``_ln_quant_kernel`` (certifiedgpt_tpu/ops/quantization.py
    :208). CPU tensors take ``_ln_quant_rows_plain``; bf16 CUDA tensors
    launch ``ln_quant_kernel`` (csrc/row_quant.cu), for any row count, with
    gamma and beta read in their own dtype (bf16 or f32)."""
    if _device_kind(x) == "cpu":
        return _ln_quant_rows_plain(x, scale, bias, eps)
    x2 = x.contiguous()
    m, k = _check_rows(x2, "ln_quant_rows")
    gamma, gamma_f32, beta, beta_f32 = _check_ln_params(scale, bias, x)
    xq, xs = _row_outputs(x)
    if m == 0:
        return xq, xs
    code = cuda_kernels.build().lib.cgpt_ln_quant(
        x2.data_ptr(), gamma.data_ptr(), gamma_f32, beta.data_ptr(), beta_f32,
        xq.data_ptr(), xs.data_ptr(), m, k, float(eps), cuda_kernels.stream_of(x),
    )
    ln_quant_rows.launches += 1
    cuda_kernels.check(code, "ln_quant_rows")
    return xq, xs


ln_quant_rows.launches = 0


# ----------------------------------------------------------------------
# whole-tower quantization
# ----------------------------------------------------------------------
def quantize_modules(params: Dict[str, Any], modules: tuple = None) -> Dict[str, Any]:
    """Quantize the stacked layer kernels of a ``{"layers": {mod: leaves}}``
    tree to per-(layer, out-channel) int8; every other leaf is kept.
    ``modules=None`` quantizes every module that has a ``kernel``."""
    out = dict(params)
    layers = {}
    for mod, leaves in params["layers"].items():
        if (modules is None or mod in modules) and "kernel" in leaves:
            new = {k: v for k, v in leaves.items() if k != "kernel"}
            new.update(quantize_stacked_kernel(leaves["kernel"]))
            layers[mod] = new
        else:
            layers[mod] = leaves
    out["layers"] = layers
    return out


def quantize_llama(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every stacked layer kernel of a decoder tree; embeddings,
    norms and the lm_head stay in their float dtype."""
    return quantize_modules(params)


def quantize_eva_vit(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the qkv/proj/fc1/fc2 stacked kernels of a ViT tree."""
    return quantize_modules(params, modules=("qkv", "proj", "fc1", "fc2"))
