"""The decoder block's elementwise chains: residual add + RMSNorm (+ int8
row quant), rotary, SiLU x up (+ int8 row quant), and their backward.

The JAX package's decoder block (certifiedgpt_tpu/models/llama.py:214-287)
is XLA code with no Pallas kernel: XLA fuses ``rms_norm``
(models/layers.py:110), the W8A8 input's ``quantize_rows``
(ops/quantization.py:52-65), ``apply_rotary`` (layers.py:150), the residual
adds (llama.py:281, :286) and ``silu(gate) * up`` (llama.py:284-286) into a
few passes, and in a training step autodiff differentiates them and XLA
fuses the backward too. Here they are six hand-written CUDA kernels
(``csrc/elementwise.cu``), each with a bf16 and an f32 instance:

- ``add_rms_norm``: ``x + y`` rounded to the activation dtype, then the
  RMSNorm in f32, written as rows or as int8 codes with one f32 scale a row;
- ``rotary``: q and k of one layer rotated in one launch (in place, or into
  new tensors), the cos/sin rows gathered by the ``[B, S]`` positions on
  the device;
- ``silu_mul``: ``silu(gate) * up``, written as rows or as int8 codes;
- ``add_rms_norm_grad``, ``rotary_grad``, ``silu_mul_grad``: the backward
  of each, as autograd computes it for the plain chain.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version beside it (the exact composition of the decoder's
chain, or of autograd's backward of it), a CUDA tensor launches the kernel
or raises. ``<wrapper>.launches`` counts the launches. The kernels allocate
nothing, never synchronize and read no host value, so a decode step that
runs them can be captured in a CUDA graph; the rotary tables are built once
per (device, head_dim, max_len, theta) by ``rotary_tables`` and must exist
before a capture.

The decoder calls the differentiable ops ``residual_norm``, ``rotate_qk``
and ``swiglu``. Where autograd does not record (the prefill, the decode
step, a validation batch) they call the forward wrappers and nothing else;
where it records (training) they run as ``torch.autograd.Function``s whose
forward is the same wrappers' and whose backward is the backward kernels'.
On the W8A8 path the norm's int8 codes feed every product that shares its
output (q/k/v, gate/up) and ``silu_mul``'s feed the down_proj, as XLA's CSE
quantizes each shared input once for the JAX package; their backward is the
products' straight-through one (``ops/quantization.py::_grad_input``), so no
activation besides the residual stream, gate and up is saved.
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
#: widest row ``add_rms_norm_grad`` takes (kMaxGradRowWidth: two f32 rows)
MAX_GRAD_ROW_WIDTH = 16384

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


def _rotary_plain(q, k, cos, sin, positions, out=None):
    """``rotary`` in plain PyTorch: new tensors (copied into ``out`` when
    given), nothing in place."""
    rq, rk = apply_rotary_plain(q, cos, sin, positions), apply_rotary_plain(k, cos, sin, positions)
    return (rq, rk) if out is None else (out[0].copy_(rq), out[1].copy_(rk))


def _silu_mul_plain(gate: torch.Tensor, up: torch.Tensor, quantize: bool = False):
    """``silu_mul`` in plain PyTorch: ``silu(gate)`` in f32 rounded to the
    dtype, times ``up`` in the dtype, and with ``quantize`` its
    ``quantize_rows``."""
    out = F.silu(gate.float()).to(gate.dtype) * up
    return Q._quantize_rows_plain(out) if quantize else out


def _add_rms_norm_grad_plain(s: torch.Tensor, g: torch.Tensor, gs: Optional[torch.Tensor],
                             scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``add_rms_norm_grad`` in plain PyTorch: autograd's backward of
    ``rms_norm_plain`` (its steps and roundings), from the saved sum ``s``
    and the output's gradient ``g``, plus ``gs`` in the dtype. In f32 no
    rounding separates the norm's two terms from ``gs``, and autograd adds
    ``gs`` first."""
    s32 = s.float()
    gw = g.float() * scale.float()
    r = torch.rsqrt(s32.square().mean(dim=-1, keepdim=True) + eps)
    gr = (gw * s32).sum(dim=-1, keepdim=True)
    a, b = gw * r, ((-0.5 * gr) * r.pow(3) / s.shape[-1]) * (2.0 * s32)
    if gs is not None and s.dtype == torch.float32:
        return (gs + a) + b
    gx = (a + b).to(s.dtype)
    return gx if gs is None else gx + gs


def _rotate_back_plain(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Autograd's backward of ``apply_rotary_plain`` in ``g``: ``g * cos``
    plus ``rotate_half``'s transpose of ``g * sin``, in f32, rounded."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    g32 = g.float()
    t = g32 * s
    half = g.shape[-1] // 2
    return (g32 * c + torch.cat([t[..., half:], -t[..., :half]], dim=-1)).to(g.dtype)


def _rotary_grad_plain(gq, gk, cos, sin, positions):
    """``rotary_grad`` in plain PyTorch."""
    return (_rotate_back_plain(gq, cos, sin, positions),
            _rotate_back_plain(gk, cos, sin, positions))


def _silu_mul_grad_plain(g: torch.Tensor, gate: torch.Tensor, up: torch.Tensor):
    """``silu_mul_grad`` in plain PyTorch: autograd's backward of
    ``_silu_mul_plain``, ``(g_gate, g_up)``."""
    act = F.silu(gate.float()).to(gate.dtype)
    g_gate = torch.ops.aten.silu_backward((g * up).float(), gate.float()).to(gate.dtype)
    return g_gate, g * act


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


def _check_heads(name: str, t: torch.Tensor, pair: int) -> None:
    if t.shape[3] % 4 or t.stride(3) != 1 or t.data_ptr() % pair or any(
            st % 2 for st in t.stride()[:3]):
        raise ValueError(f"rotary: {name} needs a head width that is a multiple of 4, "
                         f"contiguous within a head, and pairs on {pair}-byte boundaries")


def _launch_rotary(q, k, oq, ok, cos, sin, positions, inverse: bool) -> None:
    """``cgpt_rotary`` from q, k into oq, ok (the same tensors in place)."""
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
    for name, t in (("q", q), ("k", k), ("out q", oq), ("out k", ok)):
        _check_heads(name, t, pair)
    if oq.shape != q.shape or ok.shape != k.shape or oq.dtype != q.dtype or ok.dtype != q.dtype:
        raise ValueError("rotary: the outputs must match q and k in shape and dtype")
    code = cuda_kernels.build().lib.cgpt_rotary(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3], oq.data_ptr(),
        *oq.stride()[:3], ok.data_ptr(), *ok.stride()[:3], cos.data_ptr(), sin.data_ptr(),
        positions.data_ptr(), *positions.stride(), int(positions.dtype == torch.int64), b, s,
        hq, k.shape[2], dh, cos.shape[0], int(q.dtype == torch.float32), int(inverse),
        cuda_kernels.stream_of(q))
    cuda_kernels.check(code, "rotary_grad" if inverse else "rotary")


def rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           positions: torch.Tensor, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, Dh] and k [B, S, Hk, Dh] rotated by the rows of the f32
    tables [max_len, Dh] at ``positions`` [B, S] (int32 or int64, on q's
    device): ``x * cos + rotate_half(x) * sin`` in f32, rounded to the
    dtype. Returns ``(q, k)`` rotated: in place, or with ``out`` (two
    tensors shaped as q and k) written there.

    Replaces the XLA-fused ``apply_rotary`` of q and k in the JAX package's
    decoder (certifiedgpt_tpu/models/layers.py:150, llama.py:235-236). CPU
    tensors take ``_rotary_plain``, which returns new tensors (copied into
    ``out`` when given); bf16 and f32 CUDA tensors launch ``rotary_kernel``
    (csrc/elementwise.cu) once for both, bit for bit the plain version's."""
    if Q._device_kind(q) == "cpu":
        return _rotary_plain(q, k, cos, sin, positions, out)
    oq, ok = (q, k) if out is None else out
    _launch_rotary(q, k, oq, ok, cos, sin, positions, inverse=False)
    rotary.launches += 1
    return oq, ok


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


def add_rms_norm_grad(s: torch.Tensor, g: torch.Tensor, gs: Optional[torch.Tensor],
                      scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The gradient of ``x`` (and of ``y``) through ``s = x + y`` and its
    RMSNorm with the ``scale`` weight [K]: from the saved sum ``s`` [..., K]
    and the gradient ``g`` of the norm's output, ``r = rsqrt(mean(s^2) +
    eps)`` and ``g w r - s r^3 mean(g w s)`` in f32, rounded to the dtype,
    plus ``gs`` (the gradient of s from its other uses, or None) in the
    dtype. Returns a new tensor.

    The backward of the XLA-fused residual add + ``rms_norm`` of the JAX
    package's training step (certifiedgpt_tpu/models/layers.py:110,
    llama.py:281, :286). CPU tensors take ``_add_rms_norm_grad_plain``
    (autograd's backward of the plain chain, step by step); bf16 and f32
    CUDA tensors launch ``add_rms_norm_grad_kernel`` (csrc/elementwise.cu):
    one block a row, s and g read once, both row sums in one pass, which
    run in the kernel's order."""
    if Q._device_kind(s) == "cpu":
        return _add_rms_norm_grad_plain(s, g, gs, scale, eps)
    _check_dtype(s, "add_rms_norm_grad")
    k = s.shape[-1]
    for name, t in (("g", g), ("gs", gs)):
        if t is not None and (t.shape != s.shape or t.dtype != s.dtype or t.device != s.device):
            raise ValueError(f"add_rms_norm_grad: {name} {tuple(t.shape)} {t.dtype} must match "
                             f"s {tuple(s.shape)} {s.dtype} on {s.device}")
    if scale.shape != (k,) or scale.dtype not in _DTYPES or scale.device != s.device:
        raise ValueError(f"add_rms_norm_grad: scale must be [{k}] bf16 or f32 on {s.device}")
    if k % 4 or k > MAX_GRAD_ROW_WIDTH:
        raise ValueError(f"add_rms_norm_grad: row width {k} must be a multiple of 4 and at most "
                         f"{MAX_GRAD_ROW_WIDTH}")
    s2, g2 = _rows_ready(s), _rows_ready(g)
    gs2 = None if gs is None else _rows_ready(gs)
    gx = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    m = s.numel() // k
    if m == 0:
        return gx
    scale = scale.contiguous()
    code = cuda_kernels.build().lib.cgpt_add_rms_norm_grad(
        s2.data_ptr(), g2.data_ptr(), _ptr(gs2), scale.data_ptr(),
        int(scale.dtype == torch.float32), gx.data_ptr(), m, k, float(eps),
        int(s.dtype == torch.float32), cuda_kernels.stream_of(s))
    add_rms_norm_grad.launches += 1
    cuda_kernels.check(code, "add_rms_norm_grad")
    return gx


cuda_kernels.launch_counter(add_rms_norm_grad, r"\badd_rms_norm_grad_kernel\b")


def rotary_grad(gq: torch.Tensor, gk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of q and k through ``rotary``: the transpose of the
    rotation, ``g1 cos + g2 sin`` and ``g2 cos - g1 sin`` of a head's halves
    (the rotation by -theta), in f32, rounded. Returns new tensors: autograd
    may still read ``gq`` and ``gk``.

    The backward of the XLA-fused ``apply_rotary`` of the JAX package's
    training step (certifiedgpt_tpu/models/layers.py:150). CPU tensors take
    ``_rotary_grad_plain``; bf16 and f32 CUDA tensors launch
    ``rotary_grad_kernel`` (csrc/elementwise.cu, the rotary's loop with the
    sign flipped) once for both, bit for bit the plain version's."""
    if Q._device_kind(gq) == "cpu":
        return _rotary_grad_plain(gq, gk, cos, sin, positions)
    pair = 2 * gq.element_size()
    gq, gk = (t if t.stride(3) == 1 and t.data_ptr() % pair == 0
              and not any(st % 2 for st in t.stride()[:3]) else t.contiguous() for t in (gq, gk))
    oq = torch.empty(gq.shape, dtype=gq.dtype, device=gq.device)
    ok = torch.empty(gk.shape, dtype=gk.dtype, device=gk.device)
    _launch_rotary(gq, gk, oq, ok, cos, sin, positions, inverse=True)
    rotary_grad.launches += 1
    return oq, ok


cuda_kernels.launch_counter(rotary_grad, r"\brotary_grad_kernel\b")


def silu_mul_grad(g: torch.Tensor, gate: torch.Tensor, up: torch.Tensor):
    """The gradients ``(g_gate, g_up)`` of ``silu(gate) * up`` (the SiLU in
    f32 rounded to the dtype, as ``silu_mul``): ``g_up = g a`` with ``a =
    silu(gate)`` rounded, ``g_gate = (g up) sig(gate) (1 + gate (1 -
    sig(gate)))`` in f32 from ``g up`` rounded, each rounded to the dtype.

    The backward of the XLA-fused ``silu(gate) * up`` of the JAX package's
    training step (certifiedgpt_tpu/models/llama.py:284-286). CPU tensors
    take ``_silu_mul_grad_plain``; bf16 and f32 CUDA tensors launch
    ``silu_mul_grad_kernel`` (csrc/elementwise.cu): three reads and two
    writes in one pass, bit for bit the plain version's (PyTorch's
    ``silu_backward`` on the card)."""
    if Q._device_kind(g) == "cpu":
        return _silu_mul_grad_plain(g, gate, up)
    _check_dtype(g, "silu_mul_grad")
    for name, t in (("gate", gate), ("up", up)):
        if t.shape != g.shape or t.dtype != g.dtype or t.device != g.device:
            raise ValueError(f"silu_mul_grad: {name} {tuple(t.shape)} {t.dtype} must match g "
                             f"{tuple(g.shape)} {g.dtype}")
    if g.shape[-1] % 4:
        raise ValueError(f"silu_mul_grad: row width {g.shape[-1]} must be a multiple of 4")
    g2, gate2, up2 = _rows_ready(g), _rows_ready(gate), _rows_ready(up)
    g_gate = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    g_up = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if g.numel() == 0:
        return g_gate, g_up
    code = cuda_kernels.build().lib.cgpt_silu_mul_grad(
        g2.data_ptr(), gate2.data_ptr(), up2.data_ptr(), g_gate.data_ptr(), g_up.data_ptr(),
        g.numel(), int(g.dtype == torch.float32), cuda_kernels.stream_of(g))
    silu_mul_grad.launches += 1
    cuda_kernels.check(code, "silu_mul_grad")
    return g_gate, g_up


cuda_kernels.launch_counter(silu_mul_grad, r"\bsilu_mul_grad_kernel\b")


# ----------------------------------------------------------------------
# the decoder's differentiable ops
# ----------------------------------------------------------------------
def _records(*tensors) -> bool:
    """Whether autograd records an op on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _dense_leaves(dense) -> tuple:
    """``(kernel_q, scale, bias)`` of each int8 dense leaf, flattened."""
    return tuple(t for p in dense for t in (p["kernel_q"], p["scale"], p.get("bias")))


def _products(xq, xs, flat, dtype) -> tuple:
    """The W8A8 products of the codes ``(xq, xs)`` with each ``(kernel_q,
    scale, bias)`` of ``flat``, in ``dtype``."""
    return tuple(Q._w8a8_epilogue(xq, xs, flat[i], flat[i + 1], dtype, flat[i + 2])
                 for i in range(0, len(flat), 3))


def _save_products(ctx, flat) -> tuple:
    """Records the biases' dtypes on ``ctx``; returns the kernels and their
    channel scales, the products' tensors that their backward reads."""
    ctx.bias_dtypes = tuple(None if b is None else b.dtype for b in flat[2::3])
    return tuple(t for i, t in enumerate(flat) if i % 3 != 2)


def _products_backward(ctx, grads, kernels, dtype, first: int):
    """The products' backward: the sum of their straight-through input
    gradients (``Q._grad_input``), the last product's first, the order in
    which autograd sums a shared input's uses when each product is an op
    of its own; and each product's ``(None, None, bias gradient)``, the
    bias's where autograd asks for one (the output gradient summed over
    the rows, in the bias's dtype)."""
    total = None
    for i in reversed(range(len(grads))):
        if grads[i] is not None:
            gi = Q._grad_input(grads[i], kernels[2 * i], kernels[2 * i + 1], dtype)
            total = gi if total is None else total + gi
    extra = []
    for i, (g, dt) in enumerate(zip(grads, ctx.bias_dtypes)):
        want = dt is not None and g is not None and ctx.needs_input_grad[first + 3 * i + 2]
        extra += [None, None, g.reshape(-1, g.shape[-1]).sum(dim=0).to(dt) if want else None]
    return total, tuple(extra)


def _norm_forward(x, y, scale, eps, flat):
    """``(s, outs)``: the sum and the normalized rows, or their codes' W8A8
    products with each ``(kernel_q, scale, bias)`` of ``flat``."""
    s, out = add_rms_norm(x, y, scale, eps, quantize=bool(flat))
    return s, (_products(*out, flat, x.dtype) if flat else (out,))


class _ResidualNorm(torch.autograd.Function):
    """``residual_norm`` where autograd records it. Forward: ``add_rms_norm``
    (on the W8A8 path with its codes, and the products sharing them).
    Backward: the products' straight-through input gradients summed, then
    ``add_rms_norm_grad`` into x's and y's gradient. Saved: the sum ``s``
    (which the residual stream holds anyway), the scale, the int8 kernels
    and their channel scales; no f32 intermediate."""

    @staticmethod
    def forward(ctx, x, y, scale, eps, *flat):
        ctx.set_materialize_grads(False)
        ctx.eps, ctx.has_y = eps, y is not None
        s, outs = _norm_forward(x, y, scale, eps, flat)
        ctx.save_for_backward(s, scale, *_save_products(ctx, flat))
        return ((s,) if y is not None else ()) + outs

    @staticmethod
    def backward(ctx, *grads):
        s, scale, *kernels = ctx.saved_tensors
        gs, grads = (grads[0], grads[1:]) if ctx.has_y else (None, grads)
        if kernels:
            gh, extra = _products_backward(ctx, grads, kernels, s.dtype, 4)
        else:
            gh, extra = grads[0], ()
        gx = gs if gh is None else add_rms_norm_grad(s, gh, gs, scale, ctx.eps)
        g_scale = None
        if ctx.needs_input_grad[2] and gh is not None:
            # autograd's gradient of the plain chain's scale: a plain reduction
            s32 = s.float()
            normed = s32 * torch.rsqrt(s32.square().mean(dim=-1, keepdim=True) + ctx.eps)
            g_scale = (gh.float() * normed).sum_to_size(scale.shape).to(scale.dtype)
        return (gx, gx if ctx.has_y else None, g_scale, None) + extra


def residual_norm(x: torch.Tensor, y: Optional[torch.Tensor], scale: torch.Tensor,
                  eps: float = 1e-6, dense=None):
    """``(s, out)``: the residual stream ``s = x + y`` (``x`` when ``y`` is
    None) and its RMSNorm, as ``add_rms_norm`` computes them, differentiable
    in x, y and the scale. With ``dense`` (a list of int8 dense leaves:
    ``kernel_q``, ``scale``, optional ``bias``) ``out`` is the list of their
    W8A8 products on the normalized rows' int8 codes, which are computed
    once for all of them; their backward is the straight-through one of
    ``ops/quantization.py::w8a8_matmul``."""
    flat = () if dense is None else _dense_leaves(dense)
    if _records(x, y, scale, *flat):
        outs = _ResidualNorm.apply(x, y, scale, eps, *flat)
        s, outs = (outs[0], outs[1:]) if y is not None else (x, outs)
    else:
        s, outs = _norm_forward(x, y, scale, eps, flat)
    return s, (outs[0] if dense is None else list(outs))


class _RotateQK(torch.autograd.Function):
    """``rotate_qk`` where autograd records it: ``rotary`` into new tensors
    (autograd may hold the product outputs), then ``rotary_grad``. Saved:
    the tables and the positions."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, positions):
        ctx.save_for_backward(cos, sin, positions)
        return rotary(q, k, cos, sin, positions, out=(
            torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=k.device)))

    @staticmethod
    def backward(ctx, gq, gk):
        return (*rotary_grad(gq, gk, *ctx.saved_tensors), None, None, None)


def rotate_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rotary`` of q and k, differentiable: in place where autograd does
    not record, into new tensors where it does."""
    if _records(q, k):
        return _RotateQK.apply(q, k, cos, sin, positions)
    return rotary(q, k, cos, sin, positions)


def _swiglu_forward(gate, up, flat):
    if not flat:
        return silu_mul(gate, up)
    return _products(*silu_mul(gate, up, quantize=True), flat, gate.dtype)[0]


class _SwiGLU(torch.autograd.Function):
    """``swiglu`` where autograd records it. Forward: ``silu_mul`` (on the
    W8A8 path its codes, then the down_proj product). Backward: the
    product's straight-through input gradient, then ``silu_mul_grad``.
    Saved: gate and up (and the int8 kernel with its channel scale)."""

    @staticmethod
    def forward(ctx, gate, up, *flat):
        ctx.save_for_backward(gate, up, *_save_products(ctx, flat))
        return _swiglu_forward(gate, up, flat)

    @staticmethod
    def backward(ctx, g):
        gate, up, *kernels = ctx.saved_tensors
        extra = ()
        if kernels:
            g, extra = _products_backward(ctx, (g,), kernels, gate.dtype, 2)
        return silu_mul_grad(g, gate, up) + extra


def swiglu(gate: torch.Tensor, up: torch.Tensor, dense=None) -> torch.Tensor:
    """``silu(gate) * up`` as ``silu_mul`` computes it, differentiable in
    gate and up; with ``dense`` (an int8 dense leaf) its W8A8 product on
    that product's int8 codes (the down_proj), whose backward is the
    straight-through one."""
    flat = () if dense is None else _dense_leaves([dense])
    if _records(gate, up, *flat):
        return _SwiGLU.apply(gate, up, *flat)
    return _swiglu_forward(gate, up, flat)
