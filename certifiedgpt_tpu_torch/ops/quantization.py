"""Int8 quantization: weight-only, W8A8 and the fused row-quant kernels.

Port of ``certifiedgpt_tpu/ops/quantization.py``. Layout as there: a
quantized dense leaf is ``{"kernel_q": int8 [in, out], "scale": f32 [out]}``
(stacked layers: ``[L, in, out]`` / ``[L, out]``). Quantization is
symmetric, rounds half to even and clips to +-127.

Two of the repository's Pallas TPU kernels live here as hand-written CUDA
kernels (``csrc/row_quant.cu``): ``ln_quant_rows`` (LayerNorm + row quant)
and ``gelu_quant_rows`` (GELU + row quant). So do four ops that the JAX
package leaves to XLA's fusion: ``quantize_rows`` (the same file's kernel
with the identity as its transform), ``w8a8_product`` (the int8 product
with its rescale and bias, ``csrc/w8a8_gemm.cu``), ``w8a8_epilogue`` (the
rescale alone, of int32 sums added over tensor-parallel ranks,
``csrc/w8a8_epilogue.cu``) and ``int8_weight_forward`` (the weight-only
product, ``csrc/int8_weight_matmul.cu``). Each wrapper dispatches on the
tensor's device: a CPU tensor takes the plain PyTorch version next to it,
a CUDA tensor launches the kernel or raises. ``<wrapper>.launches`` counts
the kernel launches.

The JAX package's W8A8 product is an einsum accumulated in f32, into whose
epilogue XLA folds the rescale (exact below 2^24 and within one f32 ulp of
the sum above it). Here it is one kernel on CUDA: the int8 product summed
exactly in int32 on the tensor cores, rescaled and rounded in registers
(``w8a8_product``; the sums differ from JAX's by less than 1e-7 relative
before the output rounding); and an f32 product of the int8 values on the
CPU (exact below 2^24), then the plain rescale. The kernel reads the int8
kernel column-major (``int8_kernel_layout``), the layout in which
``models/model_zoo.py`` and ``models/convert.py`` store it.

``w8a8_matmul``, ``w8a8_gelu_matmul`` and the weight-only product
``int8_weight_matmul`` are ``torch.autograd.Function``s, differentiable in
their activation by the JAX package's straight-through estimators: the
backward multiplies by the dequantized weight and saves only the int8
kernel and its scale. The kernels and scales get no gradient.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops import cuda_kernels

#: widest row the row-quant kernels take (csrc/row_quant.cu kMaxRowWidth)
MAX_ROW_WIDTH = 8192
#: widest row ``quantize_rows``' kernel takes (kMaxIdentityRowWidth)
MAX_IDENTITY_ROW_WIDTH = 32768


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


def _quantize_rows_plain(x: torch.Tensor,
                         reduce_amax: Optional[Callable[[torch.Tensor], None]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows`` in plain PyTorch: the scale ``max(amax, 1e-8) /
    127`` and the codes ``round(x / xs)`` each one IEEE division, as in the
    JAX package (certifiedgpt_tpu/ops/quantization.py:52-65), on every
    device."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if reduce_amax is not None:
        reduce_amax(amax)
    xs = ieee_div(amax.clamp_min(1e-8), 127.0)
    xq = torch.round(x32 / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def quantize_rows(x: torch.Tensor, reduce_amax: Optional[Callable[[torch.Tensor], None]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization of ``x [..., K]``:
    ``(xq int8, xs f32 [..., 1])`` with ``x ~ xq * xs``, rounding half to
    even, as ``jnp.round`` does. ``reduce_amax``, when given, turns the
    rows' ``|x|`` max ``[..., 1]`` in place into the max of the whole rows,
    of which ``x`` holds a part (a MAX over the ranks that hold the other
    columns): that call keeps the plain two-step form on every device, the
    collective lying between its two passes.

    Replaces the XLA-fused ``quantize_rows`` of the JAX package. CPU
    tensors take ``_quantize_rows_plain``; bf16 CUDA tensors launch
    ``quant_rows_kernel`` and f32 ones ``quant_rows_f32_kernel``
    (csrc/row_quant.cu), whose codes and scales are the plain version's bit
    for bit."""
    if _device_kind(x) == "cpu" or reduce_amax is not None:
        return _quantize_rows_plain(x, reduce_amax)
    x2 = x.contiguous()
    lib = cuda_kernels.build().lib
    if x.dtype == torch.float32:
        m, k, entry = math.prod(x.shape[:-1]), x.shape[-1], lib.cgpt_quant_rows_f32
    else:
        m, k = _check_rows(x2, "quantize_rows", MAX_IDENTITY_ROW_WIDTH)
        entry = lib.cgpt_quant_rows
    xq, xs = _row_outputs(x)
    if m == 0:
        return xq, xs
    code = entry(x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, cuda_kernels.stream_of(x))
    quantize_rows.launches += 1
    cuda_kernels.check(code, "quantize_rows")
    return xq, xs


cuda_kernels.launch_counter(quantize_rows, r"\bquant_rows(_f32)?_kernel\b")


def int8_kernel_layout(kernel_q: torch.Tensor) -> torch.Tensor:
    """The same ``[..., in, out]`` int8 kernel stored column-major (each
    output channel's ``in`` values contiguous), the operand layout of the
    W8A8 and weight-only kernels on CUDA. Values and shape are unchanged."""
    return kernel_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def int8_accumulate(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8 @ kernel_q [K, N] int8`` accumulated exactly: int32
    on CUDA (``w8a8_product``'s kernel writing its sums), f32 on the CPU
    (exact below 2^24). A tensor-parallel product sums these partials over
    its ranks, then ``w8a8_epilogue`` rescales them."""
    if _device_kind(xq) == "cpu":
        return xq.float() @ kernel_q.float()
    m, n = xq.shape[0], kernel_q.shape[1]
    acc = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    return _launch_w8a8_gemm(xq, kernel_q, None, None, None, acc, _OUT_I32)


def w8a8_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x [..., in] @ int8 kernel [in, out]`` with dynamic per-row
    activation quant: ``(xq @ wq) * xs * ws`` in f32, cast to x's dtype,
    plus ``bias`` in x's dtype when given (the dense layer's add, done in
    the same pass). Differentiable in ``x`` (and ``bias``) by the
    straight-through estimator of the JAX package's ``custom_vjp``
    (``_W8A8Matmul``)."""
    return _W8A8Matmul.apply(x, kernel_q, scale, bias)


def _w8a8_epilogue_plain(acc, xs, scale, bias, dtype) -> torch.Tensor:
    """``w8a8_epilogue`` in plain PyTorch: ``(acc * xs * ws)`` in f32,
    rounded to ``dtype``, then ``+ bias`` in ``dtype`` (the JAX package's
    ``w8a8_matmul`` and the dense layer's bias add)."""
    out = (acc.float() * xs * scale).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def w8a8_epilogue(acc: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 product's accumulator ``acc [M, N]`` (int32 on CUDA, f32 on
    the CPU) times the row scales ``xs [M, 1]`` and the channel scales
    ``scale [N]``, rounded to ``dtype``, plus ``bias [N]``: one pass.

    Replaces the rescale XLA fuses into the JAX package's int8 einsum
    (certifiedgpt_tpu/ops/quantization.py:68, :308). CPU tensors take
    ``_w8a8_epilogue_plain``; CUDA launches ``cgpt_w8a8_epilogue``
    (csrc/w8a8_epilogue.cu, bf16 or f32 out), equal to the plain version
    bit for bit."""
    if _device_kind(acc) == "cpu":
        return _w8a8_epilogue_plain(acc, xs, scale, bias, dtype)
    m, n = acc.shape
    if acc.dtype != torch.int32 or dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a8_epilogue: the CUDA kernel takes an int32 accumulator to bf16 "
                        f"or f32, got {acc.dtype} to {dtype}")
    if n % 4 or acc.stride(1) != 1 or acc.stride(0) % 4 or acc.data_ptr() % 16:
        raise ValueError("w8a8_epilogue: the accumulator's rows must be 16-byte aligned with "
                         f"a width that is a multiple of 4, got {tuple(acc.shape)}")
    xs = xs.reshape(m).float().contiguous()
    ws = scale.float().contiguous()
    if ws.shape != (n,):
        raise ValueError(f"w8a8_epilogue: scale must be [{n}], got {tuple(scale.shape)}")
    if ws.data_ptr() % 16:
        ws = ws.clone()
    if bias is not None:
        bias = bias.to(dtype).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"w8a8_epilogue: bias must be [{n}], got {tuple(bias.shape)}")
    out = torch.empty((m, n), dtype=dtype, device=acc.device)
    if m == 0:
        return out
    code = cuda_kernels.build().lib.cgpt_w8a8_epilogue(
        acc.data_ptr(), acc.stride(0), xs.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
        int(dtype == torch.float32), cuda_kernels.stream_of(acc))
    w8a8_epilogue.launches += 1
    cuda_kernels.check(code, "w8a8_epilogue")
    return out


cuda_kernels.launch_counter(w8a8_epilogue, r"\bw8a8_epilogue_kernel\b")


#: the W8A8 kernel's output kinds (cgpt_w8a8_gemm's out_kind)
_OUT_BF16, _OUT_F32, _OUT_I32 = 0, 1, 2


def _w8a8_product_plain(xq, xs, kernel_q, scale, bias, dtype) -> torch.Tensor:
    """``w8a8_product`` in plain PyTorch: the f32 product of the int8
    values (exact below 2^24), then ``_w8a8_epilogue_plain``."""
    acc = xq.float() @ kernel_q.float()
    return _w8a8_epilogue_plain(acc, xs.reshape(-1, 1), scale, bias, dtype)


#: csrc/w8a8_gemm.cu's tile of a launch that splits K (rows, channels), and
#: the K values of its step
W8A8_SPLIT_TILE = (128, 64)
W8A8_BLOCK_K = 128


#: K steps a split keeps at the least: below, writing and adding the
#: partial sums costs more than the split saves
W8A8_SPLIT_MIN_STEPS = 8


def w8a8_splits(m: int, n: int, k: int, sms: int) -> int:
    """How many ways the W8A8 kernel splits the K of an ``[m, k] x [k, n]``
    product on a card of ``sms`` SMs: 1 above one row tile; else enough
    (channel tile, split) units to give each SM one, each split at least
    ``W8A8_SPLIT_MIN_STEPS`` K steps, then as few splits as keep that many
    steps each, so that every split has K steps of its own."""
    rows, width = W8A8_SPLIT_TILE
    if m > rows:
        return 1
    steps = -(-k // W8A8_BLOCK_K)
    splits = max(1, min(steps // W8A8_SPLIT_MIN_STEPS, sms // -(-n // width)))
    per = -(-steps // splits)
    return -(-steps // per)


def w8a8_scratch_ints(units: int) -> int:
    """int32 values of the W8A8 kernel's split-K scratch for ``units``
    (channel tile, split) units: each unit's partial sums over a whole
    tile, then one arrival counter a tile (a tile has at least one unit)."""
    rows, width = W8A8_SPLIT_TILE
    return units * (rows * width + 1)


#: each device's split-K scratch and its units (the device's SMs: a split
#: launch has at most that many), made once and kept
_SPLIT_SCRATCH: Dict[int, Tuple[torch.Tensor, int]] = {}


def _split_scratch(device: torch.device) -> Tuple[torch.Tensor, int]:
    """The device's split-K scratch (zeros: the counters start at zero and
    every launch leaves them so) and its units. Made at the first launch on
    the device outside a CUDA-graph capture; a capture that would make it
    raises, since its memory would come from the capture's pool. The
    launches that split K share it, so they run in order on one stream, as
    the port's do."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    found = _SPLIT_SCRATCH.get(index)
    if found is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("w8a8_product: the split-K scratch is made at the first launch "
                               f"on cuda:{index}; run one product there before a capture")
        units = torch.cuda.get_device_properties(index).multi_processor_count
        found = _SPLIT_SCRATCH[index] = (
            torch.zeros(w8a8_scratch_ints(units), dtype=torch.int32, device=device), units)
    return found


def _launch_w8a8_gemm(xq, kernel_q, xs, ws, bias, out, kind) -> torch.Tensor:
    """Launch ``cgpt_w8a8_gemm`` into ``out`` (its kind ``_OUT_*``), after
    checking the operands the kernel reads; raises on anything it does not
    take. A product of at most 128 rows splits its K (``w8a8_splits``) over
    the device's scratch (``_split_scratch``)."""
    m, k = xq.shape
    n = kernel_q.shape[1]
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError(f"w8a8_product: the CUDA kernel takes int8 rows and an int8 kernel, got "
                        f"{xq.dtype} and {kernel_q.dtype}")
    if kernel_q.shape[0] != k or k % 16 or n % 8:
        raise ValueError(f"w8a8_product: rows [{m}, {k}] @ kernel {tuple(kernel_q.shape)} need "
                         "matching K, K a multiple of 16 and N of 8")
    if kernel_q.stride(0) != 1 or kernel_q.stride(1) % 16 or kernel_q.data_ptr() % 16:
        raise ValueError("w8a8_product: the int8 kernel must be column-major "
                         "(ops.quantization.int8_kernel_layout) on 16-byte boundaries")
    if any(t is not None and t.device != out.device for t in (xq, kernel_q, xs, ws, bias)):
        raise ValueError("w8a8_product: the rows, the kernel, the scales and the bias must be "
                         f"on the output's device, {out.device}")
    if m == 0:
        return out
    x2 = xq.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    lda = x2.stride(0) if m > 1 else k  # a lone row's stride may be anything
    splits = w8a8_splits(m, n, k, torch.cuda.get_device_properties(out.device)
                         .multi_processor_count)
    scratch, units = None, 0
    if splits > 1 or not torch.cuda.is_current_stream_capturing():
        scratch, units = _split_scratch(out.device)
    code = cuda_kernels.build().lib.cgpt_w8a8_gemm(
        x2.data_ptr(), lda, kernel_q.data_ptr(), kernel_q.stride(1),
        None if xs is None else xs.data_ptr(), None if ws is None else ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), out.stride(0), m, n, k, kind,
        splits, None if scratch is None else scratch.data_ptr(), units,
        cuda_kernels.stream_of(xq))
    w8a8_product.launches += 1
    cuda_kernels.check(code, "w8a8_product")
    return out


def w8a8_product(xq: torch.Tensor, xs: torch.Tensor, kernel_q: torch.Tensor,
                 scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """``(xq @ kernel_q) * xs * scale`` rounded to ``dtype``, plus ``bias``:
    the W8A8 product of quantized rows ``xq [M, K]`` (row scales ``xs [M,
    1]``) and an int8 kernel ``[K, N]`` (channel scales ``scale [N]``).

    Replaces the JAX package's int8 einsum with the rescale and the bias
    that XLA fuses into it (certifiedgpt_tpu/ops/quantization.py:68-94,
    :308; models/layers.py:50). CPU tensors take ``_w8a8_product_plain``;
    CUDA launches ``cgpt_w8a8_gemm`` (csrc/w8a8_gemm.cu: persistent blocks,
    wgmma int8 on the tensor cores, B shared by two-block clusters, the
    rescale in registers, the store by TMA under the next tile's products,
    K split at most 128 rows; bf16 or f32 out), whose output is
    ``_w8a8_epilogue_plain`` of the exact int32 sums bit for bit. It
    takes any row count, K a multiple of 16, N of 8 and the kernel
    column-major (``int8_kernel_layout``)."""
    if _device_kind(xq) == "cpu":
        return _w8a8_product_plain(xq, xs, kernel_q, scale, bias, dtype)
    m, n = xq.shape[0], kernel_q.shape[1]
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a8_product: the CUDA kernel writes bf16 or f32, not {dtype}")
    xs = xs.reshape(m).float().contiguous()
    ws = scale.float().contiguous()
    if ws.shape != (n,):
        raise ValueError(f"w8a8_product: scale must be [{n}], got {tuple(scale.shape)}")
    if bias is not None:
        bias = bias.to(dtype).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"w8a8_product: bias must be [{n}], got {tuple(bias.shape)}")
    out = torch.empty((m, n), dtype=dtype, device=xq.device)
    kind = _OUT_F32 if dtype == torch.float32 else _OUT_BF16
    return _launch_w8a8_gemm(xq, kernel_q, xs, ws, bias, out, kind)


cuda_kernels.launch_counter(w8a8_product, r"\bw8a8_gemm_kernel\b")


def _w8a8_epilogue(xq, xs, kernel_q, scale, dtype, bias=None) -> torch.Tensor:
    """``(xq @ kernel_q) * xs * scale`` in ``dtype`` (+ ``bias``) of
    quantized rows ``xq [..., K]``, ``xs [..., 1]``: ``w8a8_product`` over
    the rows flattened."""
    lead = xq.shape[:-1]
    out = w8a8_product(xq.reshape(-1, xq.shape[-1]), xs.reshape(-1, 1), kernel_q, scale, bias,
                       dtype)
    return out.reshape(*lead, -1)


def w8a8_gelu_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``gelu(x) @ int8 kernel`` (+ ``bias``) with the gelu and the per-row
    activation quant fused (``gelu_quant_rows``). Differentiable in ``x``:
    the backward is ``(g @ w^T) * gelu'(x)`` (``_W8A8GeluMatmul``)."""
    return _W8A8GeluMatmul.apply(x, kernel_q, scale, bias)


def _dequantized_t(kernel_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``(kernel_q * scale)^T`` as ``[out, in]`` in ``dtype``: the float
    weight that the straight-through backward multiplies by."""
    return (kernel_q.float() * scale[None, :]).to(dtype).t()


def _grad_input_plain(g: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
                      dtype) -> torch.Tensor:
    """``g [..., out] @ (kernel_q * scale)^T`` in ``g``'s dtype, cast to
    ``dtype``: JAX's ``einsum("...o,io->...i", g, w)``, the dequantized
    weight made first."""
    return torch.matmul(g, _dequantized_t(kernel_q, scale, g.dtype)).to(dtype)


def w8_grad_gemm(g: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``bf16(g [M, out] @ w^T)`` with ``w = bf16(f32(kernel_q) * scale)``
    element by element, for bf16 ``g`` on the card: one launch of
    ``cgpt_w8_grad_gemm`` (csrc/w8_grad_gemm.cu), which converts the int8
    kernel into wgmma's register operand and never writes the dequantized
    weight. The kernel ``[in, out]`` column-major (``int8_kernel_layout``)."""
    if g.dim() != 2 or g.dtype != torch.bfloat16 or kernel_q.dtype != torch.int8:
        raise TypeError(f"w8_grad_gemm: takes bf16 rows [M, out] and an int8 kernel, got "
                        f"{g.dtype} {tuple(g.shape)}, {kernel_q.dtype}")
    m, n = g.shape
    k = kernel_q.shape[0]
    if kernel_q.shape[1] != n or n % 8 or k % 8:
        raise ValueError(f"w8_grad_gemm: rows [{m}, {n}] against a kernel "
                         f"{tuple(kernel_q.shape)}; in and out must be multiples of 8")
    if kernel_q.stride(0) != 1 or kernel_q.stride(1) % 16 or kernel_q.data_ptr() % 16:
        raise ValueError("w8_grad_gemm: the int8 kernel must be column-major "
                         "(ops.quantization.int8_kernel_layout) on 16-byte boundaries")
    if any(t.device != g.device for t in (kernel_q, scale)):
        raise ValueError(f"w8_grad_gemm: the kernel and its scale must be on {g.device}")
    out = torch.empty((m, k), dtype=torch.bfloat16, device=g.device)
    if m == 0:
        return out
    g2 = g.contiguous()
    if g2.data_ptr() % 16:
        g2 = g2.clone()
    ws = scale.float().contiguous()
    if ws.shape != (n,):
        raise ValueError(f"w8_grad_gemm: scale must be [{n}], got {tuple(scale.shape)}")
    code = cuda_kernels.build().lib.cgpt_w8_grad_gemm(
        g2.data_ptr(), n, kernel_q.data_ptr(), kernel_q.stride(1), ws.data_ptr(),
        out.data_ptr(), out.stride(0), m, n, k, cuda_kernels.stream_of(g))
    w8_grad_gemm.launches += 1
    cuda_kernels.check(code, "w8_grad_gemm")
    return out


cuda_kernels.launch_counter(w8_grad_gemm, r"\bw8_grad_gemm_kernel\b")


def _grad_input(g: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    """The straight-through input gradient ``g [..., out] @ (kernel_q *
    scale)^T`` rounded to ``g``'s dtype, cast to ``dtype`` (JAX's
    ``_w8a8_bwd``). bf16 ``g`` on the card takes ``w8_grad_gemm``, which
    reads the int8 kernel itself; CPU tensors and f32 ``g`` (whose reference
    product is f32) take ``_grad_input_plain``."""
    if _device_kind(g) == "cpu" or g.dtype != torch.bfloat16:
        return _grad_input_plain(g, kernel_q, scale, dtype)
    out = w8_grad_gemm(g.reshape(-1, g.shape[-1]), kernel_q, scale)
    return out.reshape(*g.shape[:-1], -1).to(dtype)


def _bias_grad(ctx, g, bias_dtype):
    """The gradient of the bias added in ``dtype`` after the product: ``g``
    summed over the leading axes, in the bias's dtype (None when the bias
    needs none)."""
    if not ctx.needs_input_grad[3]:
        return None
    return g.reshape(-1, g.shape[-1]).sum(dim=0).to(bias_dtype)


class _W8A8Matmul(torch.autograd.Function):
    """The JAX package's ``w8a8_matmul`` ``custom_vjp``
    (certifiedgpt_tpu/ops/quantization.py:68-113), with the dense layer's
    bias add after it. The forward quantizes the rows and runs the int8
    product; the backward is the float product's, ``g @ (kernel_q *
    scale)^T``, so ``round``'s zero derivative never appears. Saved for the
    backward, as in JAX: the int8 kernel, its scale and x's dtype (no
    activation, no dequantized weight); the kernel and the scale get no
    gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale, bias):
        ctx.save_for_backward(kernel_q, scale)
        ctx.x_dtype = x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        xq, xs = quantize_rows(x)
        return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype, bias)

    @staticmethod
    def backward(ctx, g):
        kernel_q, scale = ctx.saved_tensors
        return (_grad_input(g, kernel_q, scale, ctx.x_dtype), None, None,
                _bias_grad(ctx, g, ctx.bias_dtype))


class _W8A8GeluMatmul(torch.autograd.Function):
    """The JAX package's ``w8a8_gelu_matmul`` ``custom_vjp``
    (certifiedgpt_tpu/ops/quantization.py:308-345). The forward is the
    fused GELU + row quant (the CUDA kernel on the card) and the int8
    product; the backward is ``(g @ w^T) * (Phi(x) + x phi(x))`` with the
    exact erf (JAX's ``_w8a8_gelu_bwd``), not the kernel's A-S erf. Saved:
    x, the int8 kernel and its scale."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale, bias):
        ctx.save_for_backward(x, kernel_q, scale)
        ctx.bias_dtype = None if bias is None else bias.dtype
        xq, xs = gelu_quant_rows(x)
        return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel_q, scale = ctx.saved_tensors
        gh = _grad_input(g, kernel_q, scale, torch.float32)
        x32 = x.float()
        cdf = 0.5 * (1.0 + torch.erf(x32 * 2.0 ** -0.5))
        pdf = torch.exp(-0.5 * x32 * x32) * (1.0 / math.sqrt(2.0 * math.pi))
        return ((gh * (cdf + x32 * pdf)).to(x.dtype), None, None,
                _bias_grad(ctx, g, ctx.bias_dtype))


def int8_weight_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Weight-only int8 product ``(x @ kernel_q) * scale`` in x's dtype
    (the per-output-channel scale commutes with the contraction). Its
    backward saves only the int8 kernel and the scale and dequantizes when
    it runs (``_Int8WeightMatmul``): a saved float copy of every decoder
    kernel would hold gigabytes across a training step."""
    return _Int8WeightMatmul.apply(x, kernel_q, scale)


def _int8_weight_forward_plain(x, kernel_q, scale):
    """``int8_weight_forward`` in plain PyTorch: the JAX package's
    ``einsum(x, kernel_q.astype(x.dtype), preferred_element_type=f32) *
    scale``, rounded to x's dtype. On CUDA a bf16 ``x`` multiplies a bf16
    copy of the kernel into an f32 product; elsewhere both operands go to
    f32 (exact for them)."""
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        x2 = x.reshape(-1, x.shape[-1])
        acc = torch.mm(x2, kernel_q.to(x.dtype), out_dtype=torch.float32)
        acc = acc.reshape(*x.shape[:-1], -1)
    else:
        acc = torch.matmul(x.float(), kernel_q.float())
    return (acc * scale).to(x.dtype)


def int8_weight_forward(x: torch.Tensor, kernel_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ kernel_q [K, N]`` accumulated in f32, times the
    channel scales, in x's dtype: the weight-only int8 product's forward.

    Replaces the weight-only branch of the JAX package's dense
    (certifiedgpt_tpu/models/layers.py:61-76), where XLA feeds the int8 ->
    bf16 convert into the matrix unit. CPU tensors take
    ``_int8_weight_forward_plain``; bf16 and f32 CUDA tensors launch
    ``cgpt_int8_weight_matmul`` (csrc/int8_weight_matmul.cu), which reads
    the column-major int8 kernel once and makes no float copy of it; f32 x
    is multiplied on the tensor cores as three exact bf16 terms. A call
    is one kernel launch: where the launcher splits K, the splits of a tile
    form a thread-block cluster and sum their partials in shared memory, so
    no workspace and no memset go with it."""
    if _device_kind(x) == "cpu":
        return _int8_weight_forward_plain(x, kernel_q, scale)
    k, n = kernel_q.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or kernel_q.dtype != torch.int8:
        raise TypeError(f"int8_weight_forward: the CUDA kernel takes bf16 or f32 x and an int8 "
                        f"kernel, got {x.dtype} and {kernel_q.dtype}")
    if x.shape[-1] != k or k % 16 or n % 8:
        raise ValueError(f"int8_weight_forward: x [..., {x.shape[-1]}] @ kernel [{k}, {n}] "
                         "needs K a multiple of 16 and N of 8")
    if kernel_q.stride(0) != 1 or kernel_q.stride(1) % 16 or kernel_q.data_ptr() % 16:
        raise ValueError("int8_weight_forward: the int8 kernel must be column-major "
                         "(ops.quantization.int8_kernel_layout) on 16-byte boundaries")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    ws = scale.float().contiguous()
    code = cuda_kernels.build().lib.cgpt_int8_weight_matmul(
        x2.data_ptr(), k, kernel_q.data_ptr(), kernel_q.stride(1), ws.data_ptr(),
        out.data_ptr(), n, m, n, k, int(x.dtype == torch.float32), cuda_kernels.stream_of(x))
    int8_weight_forward.launches += 1
    cuda_kernels.check(code, "int8_weight_forward")
    return out.reshape(*x.shape[:-1], n)


cuda_kernels.launch_counter(int8_weight_forward, r"\bint8_weight_matmul_kernel\b")


class _Int8WeightMatmul(torch.autograd.Function):
    """Weight-only int8 product with the gradient of the JAX package's
    ``(einsum(x, kernel_q.astype(x.dtype)) * scale).astype(x.dtype)``:
    ``gx = (g * scale) @ kernel_q^T`` in x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale):
        ctx.save_for_backward(kernel_q, scale)
        ctx.x_dtype = x.dtype
        return int8_weight_forward(x, kernel_q, scale)

    @staticmethod
    def backward(ctx, g):
        kernel_q, scale = ctx.saved_tensors
        return int8_weight_grad(g, kernel_q, scale, ctx.x_dtype), None, None


def int8_weight_grad(g: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
                     dtype) -> torch.Tensor:
    """The input gradient of ``int8_weight_matmul``: ``(g * scale) @
    kernel_q^T`` in ``dtype``."""
    gs = g.float() * scale
    if g.device.type == "cuda" and dtype != torch.float32:
        gx = torch.matmul(gs.to(dtype), kernel_q.to(dtype).t())
    else:
        gx = torch.matmul(gs, kernel_q.float().t())
    return gx.to(dtype)


# ----------------------------------------------------------------------
# fused row-quant kernels: plain versions and wrappers
# ----------------------------------------------------------------------
# Abramowitz-Stegun 7.1.26 erf, as the TPU kernel computes it
# (certifiedgpt_tpu/ops/quantization.py::_erf_approx)
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)

#: lanes of a warp and values of a piece in the LayerNorm kernel's sums
_LANES, _LN_PIECE = 32, 4


def _gelu_quant_rows_plain(x: torch.Tensor):
    """``quantize_rows(gelu(x))``: exact-erf GELU in f32, rounded to x's
    dtype, then the per-row int8 quantization (the JAX package's chain off
    the TPU)."""
    return _quantize_rows_plain(F.gelu(x.float()).to(x.dtype).float())


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
    return _quantize_rows_plain((0.5 * x32 * (1.0 + erf)).to(x.dtype).float())


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
    xq, xs = _quantize_rows_plain(out.to(x.dtype).float())
    return xq.reshape(x.shape), xs.reshape(*x.shape[:-1], 1)


def _check_rows(x: torch.Tensor, name: str, widest: int = MAX_ROW_WIDTH) -> Tuple[int, int]:
    """Rows the kernels take: bf16, a width that is a multiple of 8 up to
    ``widest``, the first row on a 16-byte boundary (the bulk copies'
    alignment; the width then keeps every row there)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
    k = x.shape[-1]
    if k % 8 or k > widest:
        raise ValueError(
            f"{name}: row width {k} must be a multiple of 8 and at most {widest}"
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


cuda_kernels.launch_counter(gelu_quant_rows, r"\bgelu_quant_kernel\b")


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


cuda_kernels.launch_counter(ln_quant_rows, r"\bln_quant_kernel\b")


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
