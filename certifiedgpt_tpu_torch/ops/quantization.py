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
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops import cuda_kernels

#: widest row the row-quant kernels take (csrc/row_quant.cu kMaxChunks)
MAX_ROW_WIDTH = 8192

#: fewest rows ``torch._int_mm`` takes on CUDA (M > 16, a multiple of 8)
INT_MM_MIN_ROWS = 24


def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] float kernel -> per-out-channel symmetric int8."""
    w = kernel.float()
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def quantize_stacked_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[L, in, out] stacked float kernels -> per-(layer, out-channel) int8."""
    w32 = w.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
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
    activation quant: ``(xq @ wq) * xs * ws`` in f32, cast to x's dtype
    (forward only: the serving towers are frozen)."""
    xq, xs = quantize_rows(x)
    return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype)


def _w8a8_epilogue(xq, xs, kernel_q, scale, dtype) -> torch.Tensor:
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q)
    acc = acc.reshape(*lead, -1)
    return (acc * xs * scale).to(dtype)


def w8a8_gelu_matmul(
    x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """``gelu(x) @ int8 kernel`` with the gelu and the per-row activation
    quant fused (``gelu_quant_rows``)."""
    xq, xs = gelu_quant_rows(x)
    return _w8a8_epilogue(xq, xs, kernel_q, scale, x.dtype)


# ----------------------------------------------------------------------
# fused row-quant kernels: plain versions and wrappers
# ----------------------------------------------------------------------
def _gelu_quant_rows_plain(x: torch.Tensor):
    """``quantize_rows(gelu(x))``: exact-erf GELU in f32, rounded to x's
    dtype, then the per-row int8 quantization."""
    return quantize_rows(F.gelu(x.float()).to(x.dtype))


def _ln_quant_rows_plain(x, scale, bias, eps):
    """``quantize_rows(layer_norm(x))``: f32 LayerNorm with affine,
    rounded to x's dtype (the JAX package's ``_ln_chain_xla``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * scale.float() + bias.float()
    return quantize_rows(out.to(x.dtype))


def _check_rows(x: torch.Tensor, name: str) -> Tuple[int, int]:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
    k = x.shape[-1]
    if k % 8 or k > MAX_ROW_WIDTH:
        raise ValueError(
            f"{name}: row width {k} must be a multiple of 8 and at most "
            f"{MAX_ROW_WIDTH}"
        )
    return x.numel() // k, k


def _device_kind(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return kind


def gelu_quant_rows(x: torch.Tensor):
    """``quantize_rows(gelu(x))`` in one pass over device memory.

    Replaces ``_gelu_quant_kernel`` (certifiedgpt_tpu/ops/quantization.py
    :136). CPU tensors take ``_gelu_quant_rows_plain``; bf16 CUDA tensors
    launch ``gelu_quant_kernel`` (csrc/row_quant.cu)."""
    if _device_kind(x) == "cpu":
        return _gelu_quant_rows_plain(x)
    m, k = _check_rows(x, "gelu_quant_rows")
    x2 = x.contiguous()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    lib = cuda_kernels.build().lib
    code = lib.cgpt_gelu_quant(
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
    launch ``ln_quant_kernel`` (csrc/row_quant.cu), for any row count."""
    if _device_kind(x) == "cpu":
        return _ln_quant_rows_plain(x, scale, bias, eps)
    m, k = _check_rows(x, "ln_quant_rows")
    if scale.shape != (k,) or bias.shape != (k,):
        raise ValueError(
            f"ln_quant_rows: affine params must be [{k}], got "
            f"{tuple(scale.shape)} and {tuple(bias.shape)}"
        )
    x2 = x.contiguous()
    gamma = scale.float().contiguous()
    beta = bias.float().contiguous()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    lib = cuda_kernels.build().lib
    code = lib.cgpt_ln_quant(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), m, k, float(eps), cuda_kernels.stream_of(x),
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
