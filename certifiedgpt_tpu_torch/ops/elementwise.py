"""The decoder block's elementwise chains: residual add + RMSNorm (+ int8
row quant), rotary, SiLU x up (+ int8 row quant).

The JAX package's decoder block (certifiedgpt_tpu/models/llama.py:214-287)
is XLA code with no Pallas kernel: XLA fuses ``rms_norm``
(models/layers.py:110), the W8A8 input's ``quantize_rows``
(ops/quantization.py:52-65), ``apply_rotary`` (layers.py:150), the residual
adds (llama.py:281, :286) and ``silu(gate) * up`` (llama.py:284-286) into a
few passes. Here they are three hand-written CUDA kernels
(``csrc/elementwise.cu``), each with a bf16 and an f32 instance:

- ``add_rms_norm``: ``x + y`` rounded to the activation dtype, then the
  RMSNorm in f32, written as rows or as int8 codes with one f32 scale a row;
- ``rotary``: q and k of one layer rotated in place in one launch, the
  cos/sin rows gathered by the ``[B, S]`` positions on the device;
- ``silu_mul``: ``silu(gate) * up``, written as rows or as int8 codes.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version beside it (the exact composition of the decoder's
chain), a CUDA tensor launches the kernel or raises. ``<wrapper>.launches``
counts the launches. The kernels allocate nothing, never synchronize and
read no host value, so a decode step that runs them can be captured in a
CUDA graph; the rotary tables are built once per (device, head_dim,
max_len, theta) by ``rotary_tables`` and must exist before a capture.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops import quantization as Q

#: widest row ``add_rms_norm`` and the quantizing ``silu_mul`` take
#: (csrc/elementwise.cu kMaxRowWidth: an f32 row buffer in shared memory)
MAX_ROW_WIDTH = 32768

_DTYPES = (torch.bfloat16, torch.float32)


# ----------------------------------------------------------------------
# plain versions (the decoder's chains as eager PyTorch)
# ----------------------------------------------------------------------
def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with the ``scale`` weight, rounded to x's dtype (the
    JAX package's ``layers.rms_norm``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def _add_rms_norm_plain(x: torch.Tensor, y: Optional[torch.Tensor], scale: torch.Tensor,
                        eps: float = 1e-6, quantize: bool = False):
    """``add_rms_norm`` in plain PyTorch: ``x + y`` in x's dtype (x when
    ``y`` is None), then ``rms_norm_plain`` and, with ``quantize``,
    ``quantize_rows`` of the normalized rows."""
    if y is not None:
        x = x + y
    out = rms_norm_plain(x, scale, eps)
    return x, (Q._quantize_rows_plain(out) if quantize else out)


def make_rotary_tables(head_dim: int, max_len: int, theta: float = 10000.0,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_len, head_dim] f32 cos/sin tables (HF-LLaMA rotate-half)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rotary_tables(head_dim: int, max_len: int, theta: float = 10000.0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``make_rotary_tables``, built once per (device, head_dim, max_len,
    theta) and kept: the decoder reads the same tables at every call, and
    a captured decode step reads them at fixed addresses. Building them
    inside a CUDA graph capture would record the build without running it,
    so a table missing there raises."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, int(head_dim), int(max_len), float(theta))
    tables = _TABLES.get(key)
    if tables is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"rotary tables {key} are built inside a CUDA graph capture: "
                               "run the decoder once eagerly first")
        tables = _TABLES[key] = make_rotary_tables(head_dim, max_len, theta, device)
    return tables


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh] rotated by the rows of the f32 tables at positions
    [B, S], in f32, rounded to x's dtype (the JAX package's
    ``layers.apply_rotary``)."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x32 = x.float()
    return (x32 * c + _rotate_half(x32) * s).to(x.dtype)


def _rotary_plain(q, k, cos, sin, positions):
    """``rotary`` in plain PyTorch: new tensors, nothing in place."""
    return apply_rotary_plain(q, cos, sin, positions), apply_rotary_plain(k, cos, sin, positions)


def _silu_mul_plain(gate: torch.Tensor, up: torch.Tensor, quantize: bool = False):
    """``silu_mul`` in plain PyTorch: ``silu(gate)`` in f32 rounded to the
    dtype, times ``up`` in the dtype, and with ``quantize`` its
    ``quantize_rows``."""
    out = F.silu(gate.float()).to(gate.dtype) * up
    return Q._quantize_rows_plain(out) if quantize else out


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def _rows_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary (the kernels' vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_dtype(t: torch.Tensor, name: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 or f32, got {t.dtype}")


def _quant_outputs(shape, device):
    return (torch.empty(shape, dtype=torch.int8, device=device),
            torch.empty((*shape[:-1], 1), dtype=torch.float32, device=device))


def add_rms_norm(x: torch.Tensor, y: Optional[torch.Tensor], scale: torch.Tensor,
                 eps: float = 1e-6, quantize: bool = False):
    """``(s, out)``: ``s = x + y`` in x's dtype (``x`` itself when ``y`` is
    None), and ``out`` its RMSNorm with the ``scale`` weight [K] (bf16 or
    f32), computed in f32 and rounded to x's dtype, or with ``quantize``
    the normalized rows' int8 codes and per-row f32 scales ``(xq, xs)``, as
    ``quantize_rows`` gives them.

    Replaces the XLA-fused residual add + ``rms_norm`` (+ ``quantize_rows``)
    of the JAX package's decoder (certifiedgpt_tpu/models/llama.py:230,
    :281-283, :286, :418; models/layers.py:110). CPU tensors take
    ``_add_rms_norm_plain``; bf16 and f32 CUDA tensors launch
    ``add_rms_norm_kernel`` (csrc/elementwise.cu): one pass that reads x
    and y and writes s and the output. The sum and the rounding steps are
    the plain version's; the sum of squares runs in the kernel's order."""
    if Q._device_kind(x) == "cpu":
        return _add_rms_norm_plain(x, y, scale, eps, quantize)
    _check_dtype(x, "add_rms_norm")
    k = x.shape[-1]
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype or y.device != x.device):
        raise ValueError(f"add_rms_norm: y {tuple(y.shape)} {y.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if scale.shape != (k,) or scale.dtype not in _DTYPES or scale.device != x.device:
        raise ValueError(f"add_rms_norm: scale must be [{k}] bf16 or f32 on {x.device}, got "
                         f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if k % 4 or k > MAX_ROW_WIDTH:
        raise ValueError(f"add_rms_norm: row width {k} must be a multiple of 4 and at most "
                         f"{MAX_ROW_WIDTH}")
    x2 = _rows_ready(x)
    y2 = None if y is None else _rows_ready(y)
    s = x if y is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if quantize:
        out, (xq, xs) = None, _quant_outputs(x.shape, x.device)
    else:
        out, xq, xs = torch.empty(x.shape, dtype=x.dtype, device=x.device), None, None
    m = x.numel() // k
    if m == 0:
        return s, ((xq, xs) if quantize else out)
    scale = scale.contiguous()
    code = cuda_kernels.build().lib.cgpt_add_rms_norm(
        x2.data_ptr(), _ptr(y2), None if y is None else s.data_ptr(), scale.data_ptr(),
        int(scale.dtype == torch.float32), _ptr(out), _ptr(xq), _ptr(xs), m, k, float(eps),
        int(x.dtype == torch.float32), int(quantize), cuda_kernels.stream_of(x))
    add_rms_norm.launches += 1
    cuda_kernels.check(code, "add_rms_norm")
    return s, ((xq, xs) if quantize else out)


cuda_kernels.launch_counter(add_rms_norm, r"\badd_rms_norm_kernel\b")


def rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, Dh] and k [B, S, Hk, Dh] rotated by the rows of the f32
    tables [max_len, Dh] at ``positions`` [B, S] (int32 or int64, on q's
    device): ``x * cos + rotate_half(x) * sin`` in f32, rounded to the
    dtype. Returns ``(q, k)``.

    Replaces the XLA-fused ``apply_rotary`` of q and k in the JAX package's
    decoder (certifiedgpt_tpu/models/layers.py:150, llama.py:235-236). CPU
    tensors take ``_rotary_plain``, which returns new tensors; bf16 and f32
    CUDA tensors launch ``rotary_kernel`` (csrc/elementwise.cu) once for
    both, which rotates them in place, bit for bit the plain version's."""
    if Q._device_kind(q) == "cpu":
        return _rotary_plain(q, k, cos, sin, positions)
    _check_dtype(q, "rotary")
    b, s, hq, dh = q.shape
    if k.dtype != q.dtype or k.shape[:2] != (b, s) or k.shape[3] != dh or k.device != q.device:
        raise ValueError(f"rotary: k {tuple(k.shape)} {k.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if positions.shape != (b, s) or positions.dtype not in (torch.int32, torch.int64) \
            or positions.device != q.device:
        raise ValueError(f"rotary: positions must be [{b}, {s}] int32 or int64 on {q.device}, "
                         f"got {tuple(positions.shape)} {positions.dtype}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != dh \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"rotary: {name} must be a contiguous f32 [max_len, {dh}] table on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    if cos.shape != sin.shape:
        raise ValueError("rotary: cos and sin tables differ in shape")
    pair = 2 * q.element_size()
    for name, t in (("q", q), ("k", k)):
        if dh % 4 or t.stride(3) != 1 or t.data_ptr() % pair or any(
                st % 2 for st in t.stride()[:3]):
            raise ValueError(f"rotary: {name} needs a head width that is a multiple of 4, "
                             f"contiguous within a head, and pairs on {pair}-byte boundaries")
    code = cuda_kernels.build().lib.cgpt_rotary(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3], cos.data_ptr(),
        sin.data_ptr(), positions.data_ptr(), *positions.stride(),
        int(positions.dtype == torch.int64), b, s, hq, k.shape[2], dh, cos.shape[0],
        int(q.dtype == torch.float32), cuda_kernels.stream_of(q))
    rotary.launches += 1
    cuda_kernels.check(code, "rotary")
    return q, k


cuda_kernels.launch_counter(rotary, r"\brotary_kernel\b")


def silu_mul(gate: torch.Tensor, up: torch.Tensor, quantize: bool = False):
    """``silu(gate) * up`` in the dtype (the SiLU in f32 and rounded, as
    the JAX package's ``layers.silu``), or with ``quantize`` that product's
    int8 codes and per-row f32 scales ``(xq, xs)``.

    Replaces the XLA-fused ``silu(gate) * up`` (+ ``quantize_rows`` of the
    W8A8 down_proj's input) of the JAX package's decoder
    (certifiedgpt_tpu/models/llama.py:284-286, models/layers.py:220). CPU
    tensors take ``_silu_mul_plain``; bf16 and f32 CUDA tensors launch
    ``silu_mul_kernel`` (csrc/elementwise.cu), bit for bit the plain
    version's."""
    if Q._device_kind(gate) == "cpu":
        return _silu_mul_plain(gate, up, quantize)
    _check_dtype(gate, "silu_mul")
    if up.shape != gate.shape or up.dtype != gate.dtype or up.device != gate.device:
        raise ValueError(f"silu_mul: up {tuple(up.shape)} {up.dtype} must match gate "
                         f"{tuple(gate.shape)} {gate.dtype}")
    n = gate.shape[-1]
    if n % 4 or (quantize and n > MAX_ROW_WIDTH):
        raise ValueError(f"silu_mul: row width {n} must be a multiple of 4"
                         + (f" and at most {MAX_ROW_WIDTH}" if quantize else ""))
    g2, u2 = _rows_ready(gate), _rows_ready(up)
    if quantize:
        out, (xq, xs) = None, _quant_outputs(gate.shape, gate.device)
    else:
        out, xq, xs = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device), None, None
    m = math.prod(gate.shape[:-1])
    if m == 0:
        return (xq, xs) if quantize else out
    code = cuda_kernels.build().lib.cgpt_silu_mul(
        g2.data_ptr(), u2.data_ptr(), _ptr(out), _ptr(xq), _ptr(xs), m, n,
        int(gate.dtype == torch.float32), int(quantize), cuda_kernels.stream_of(gate))
    silu_mul.launches += 1
    cuda_kernels.check(code, "silu_mul")
    return (xq, xs) if quantize else out


cuda_kernels.launch_counter(silu_mul, r"\bsilu_mul_kernel\b")
