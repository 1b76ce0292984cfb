"""Attention kernels: flash attention and the ViT's cls-split attention.

Port of ``certifiedgpt_tpu/ops/flash_attention.py`` and of the explicit-scale
cls-split experiment ``scripts/bench_cls_split_attention.py``. Three Pallas
TPU kernels become instances of one CUDA kernel template
(``csrc/attention_common.cuh``: a persistent, warp-specialized ``wgmma``
kernel with a producer warpgroup that fills a ring of K/V tiles in swizzled
shared memory):

- ``_flash_kernel`` (:39) -> ``csrc/flash_attention.cu``, behind
  ``flash_attention`` (``[B, S, H, D]``, causal optional) and behind the two
  forms that the JAX package hands to its library kernel,
  ``builtin_flash_attention`` (``[B, S, H, D]``) and
  ``builtin_flash_attention_bhsd`` (``[B, H, S, D]``), all non-causal there;
- ``_cls_split_kernel`` (:258) -> ``csrc/cls_split_attention.cu``, behind
  ``cls_split_attention_parts`` (and its concatenated form
  ``cls_split_attention``): the patch block (N = 1024 at 448 px) attends over
  the N patch keys plus the single cls key, which seeds each row's online
  softmax; the single cls query row is computed in the same launch (the JAX
  package computes it in plain XLA);
- ``_cls_kernel`` (``scripts/bench_cls_split_attention.py:35``) -> the same
  CUDA kernel with a runtime score scale, behind
  ``cls_split_attention_scaled``.

Each wrapper dispatches on the tensor's device: CPU tensors take the plain
PyTorch version beside it (the JAX package's off-TPU path), CUDA tensors make
one launch of the kernel or raise. ``flash_attention.launches``,
``cls_split_attention_parts.launches`` and
``cls_split_attention_scaled.launches`` count the launches;
``_cls_query_row`` is the plain version of the kernel's cls row and no
wrapper calls it.

PRE-SCALING CONTRACT of the cls-split parts (as in the JAX package): the q
operands carry ``head_dim**-0.5 * log2(e)`` (``CLS_SPLIT_Q_PREMUL_LOG2E``)
folded into the qkv weights, so the softmax runs on ``exp2``; the factor
cancels in the normalization.

Head padding: the TPU pads dh = 88 to 128 lanes in device memory. The port
does not: operands are strided views at the true head dim (views of the qkv
matmul output are taken as they are), and the kernel pads the depth of
Q K^T to 96 (a multiple of the MMA depth step 16) in shared memory only (see
the sources' notes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops.attention import multi_head_attention

#: factor producers fold into q so the kernel can exp2 without rescaling
CLS_SPLIT_Q_PREMUL_LOG2E = float(math.log2(math.e))

#: key tile of the CUDA kernel; the cls-split N must be a multiple of it
KERNEL_TILE = 64

#: head dim the CUDA kernel pads to in shared memory (dh = 88 of EVA ViT-g);
#: narrower multiples of 8 are zero-padded, wider ones are refused
KERNEL_HEAD_DIM = 96


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] <-> [B, H, S, D] (a view)."""
    return x.transpose(1, 2)


def _check_rows(name: str, tensors) -> None:
    """bf16 operands of one shape, rows contiguous and 16-byte aligned (the
    kernels copy them with 16-byte ``cp.async``), head dim a multiple of 8 up
    to ``KERNEL_HEAD_DIM``."""
    shape = tensors[0][1].shape
    for arg, t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} must be bf16, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {arg} needs contiguous rows, strides that are multiples "
                f"of 8 and a 16-byte aligned start, got strides {t.stride()}"
            )
    d = shape[-1]
    if d % 8 or d > KERNEL_HEAD_DIM:
        raise ValueError(
            f"{name}: the head dim must be a multiple of 8 up to {KERNEL_HEAD_DIM}, got {d}"
        )


def _device_kind(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return kind


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
def _flash_attention_plain(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """The JAX package's off-TPU path (:174-181): plain attention on
    ``[B, S, H, D]`` with a lower-triangular mask when causal."""
    mask = None
    if causal:
        s = q.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))[None, None]
    return multi_head_attention(q, k, v, mask, scale=scale)


def _launch_flash(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The flash kernel on ``[B, H, S, D]`` views; returns a ``[B, H, S, D]``
    view of a fresh ``[B, S, H, D]`` buffer."""
    _check_rows("flash_attention", (("q", q), ("k", k), ("v", v)))
    if not scale > 0:
        raise ValueError(f"flash_attention: the softmax scale must be positive, got {scale}")
    b, h, s, d = q.shape
    out = _bhsd(torch.empty((b, s, h, d), dtype=q.dtype, device=q.device))
    lib = cuda_kernels.build().lib
    code = lib.cgpt_flash_attention(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
        b, h, s, d, float(scale) * CLS_SPLIT_Q_PREMUL_LOG2E, int(causal),
        cuda_kernels.stream_of(q),
    )
    flash_attention.launches += 1
    cuda_kernels.check(code, "flash_attention")
    return out


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, H, D] (self-attention: same S)
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention through the flash kernel; ``[B, S, H, D]`` in and out,
    ``scale`` defaults to ``D**-0.5``.

    CPU tensors take ``_flash_attention_plain``; bf16 CUDA tensors (strided
    views are taken as they are) launch ``csrc/flash_attention.cu``, which
    writes the output as a contiguous ``[B, S, H, D]`` tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind(q) == "cpu":
        return _flash_attention_plain(q, k, v, causal, scale)
    return _bhsd(_launch_flash(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale))


cuda_kernels.launch_counter(flash_attention, r"\battention_kernel<\d+,\s*true,\s*false>")


def builtin_flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal self-attention, the contract of the JAX package's library
    flash kernel (:202-255): ``[B, S, H, D]`` in and out, the sequence tail
    masked. It is ``flash_attention``: the flash kernel on CUDA, with no
    padding in device memory; plain attention on the CPU, as the JAX
    package off-TPU."""
    return flash_attention(q, k, v, scale=scale)


def builtin_flash_attention_bhsd(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    true_head_dim: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``builtin_flash_attention`` on operands in the ``[B, H, S, D]`` layout
    (:404-456), the softmax scale from ``true_head_dim`` (zero-padded lanes,
    if any, add nothing to q.k). Returns ``[B, H, S, D]``; on CUDA a view of
    a contiguous ``[B, S, H, D]`` buffer, so transposing back is free."""
    if scale is None:
        scale = true_head_dim ** -0.5
    return _bhsd(flash_attention(_bhsd(q), _bhsd(k), _bhsd(v), scale=scale))


# ----------------------------------------------------------------------
# cls-split attention
# ----------------------------------------------------------------------
def _cls_split_attention_plain(qp, kp, vp, qc, kc, vc):
    """The JAX package's exact fallback (:330-341): reassemble the cls and
    patch parts and run plain attention with ``scale = ln 2``, which undoes
    the log2(e) pre-scale (softmax(s * ln2) == softmax2(s))."""
    q = torch.cat([qc, qp], dim=2)
    k = torch.cat([kc, kp], dim=2)
    v = torch.cat([vc, vp], dim=2)
    out = _bhsd(multi_head_attention(_bhsd(q), _bhsd(k), _bhsd(v), scale=math.log(2.0)))
    return out[:, :, :1], out[:, :, 1:]


def _bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32. On CUDA bf16
    operands stay bf16 (``out_dtype`` is a CUDA-only overload); on the CPU
    they are upcast, which gives the same products and sums."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def _cls_query_row(qc, kp, vp, kc, vc, scale_log2: float = 1.0):
    """The plain version of the cls row that the cls-split kernel computes:
    the single cls query over [cls + N] keys (log2 domain, the scores
    multiplied by ``scale_log2``), as the JAX package's plain-XLA cls row
    (:371-390), with bf16 operands, f32 accumulation and f32 scores as in
    its ``preferred_element_type=f32`` einsums, the weights rounded to the
    operands' type before P.V. No wrapper calls it: tests and
    ``chip_smoke.py`` hold the kernel's row against it, and
    ``_cls_query_row.calls`` counts its calls so that a run can show that.

    Both products are batched over B with all heads at once, and K and V
    are never upcast: the scores come from K against a block-diagonal
    ``[H*D, H]`` matrix of the cls queries, and P.V keeps the diagonal
    ``[D]`` blocks of ``[H, H*D]``. K and V are read in place only when
    ``[B, N, H*D]`` is a view of them; other layouts are copied by the
    reshapes below."""
    _cls_query_row.calls += 1
    b, h, n, d = kp.shape
    k2 = kp.transpose(1, 2).reshape(b, n, h * d)
    v2 = vp.transpose(1, 2).reshape(b, n, h * d)
    eye = torch.eye(h, dtype=qc.dtype, device=qc.device)
    q_blocks = (qc[:, :, 0, :, None] * eye[None, :, None, :]).reshape(b, h * d, h)
    s_p = _bmm_f32(k2, q_blocks).transpose(1, 2)  # [B, H, N]
    s_cc = (qc[:, :, 0].float() * kc[:, :, 0].float()).sum(dim=-1, keepdim=True)
    if scale_log2 != 1.0:
        s_p = s_p * scale_log2
        s_cc = s_cc * scale_log2
    m = torch.maximum(s_p.amax(dim=-1, keepdim=True), s_cc)
    w_p = torch.exp2(s_p - m)
    w_c = torch.exp2(s_cc - m)
    denom = w_p.sum(dim=-1, keepdim=True) + w_c
    pv = _bmm_f32(w_p.to(vp.dtype), v2)  # [B, H, H*D]
    pv = pv.view(b, h, h, d).diagonal(dim1=1, dim2=2).transpose(1, 2)  # [B, H, D]
    out = (pv + w_c * vc[:, :, 0].float()) / denom
    return out[:, :, None].to(qc.dtype)


_cls_query_row.calls = 0


def _check_operands(qp, kp, vp, qc, kc, vc):
    name = "cls_split_attention_parts"
    _check_rows(name, (("qp", qp), ("kp", kp), ("vp", vp)))
    if kp.stride() != qp.stride() or vp.stride() != qp.stride():
        raise ValueError(
            f"{name}: qp, kp, vp need one stride, got {qp.stride()}, "
            f"{kp.stride()}, {vp.stride()}"
        )
    b, h, n, d = qp.shape
    if n % KERNEL_TILE:
        raise ValueError(f"{name}: needs N % {KERNEL_TILE} == 0, got N={n}")
    for arg, t in (("qc", qc), ("kc", kc), ("vc", vc)):
        if t.dtype != torch.bfloat16 or t.shape != (b, h, 1, d) or t.stride(3) != 1:
            raise ValueError(
                f"{name}: {arg} must be bf16 [B, H, 1, D] with contiguous rows, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if kc.stride() != vc.stride() or qc.stride() != kc.stride():
        raise ValueError(f"{name}: qc, kc and vc need one stride")


def _launch_cls_split(qp, kp, vp, qc, kc, vc, out_c, out_p, scale_log2: float = 1.0):
    """One launch of the cls-split CUDA kernel on checked operands: the N
    patch rows into ``out_p`` (``[B, H, N, D]``, any (b, h, n) strides) and
    the cls row into ``out_c`` (``[B, H, 1, D]``)."""
    b, h, n, d = qp.shape
    lib = cuda_kernels.build().lib
    code = lib.cgpt_cls_split_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        qp.stride(0), qp.stride(1), qp.stride(2),
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), kc.stride(0), kc.stride(1),
        out_p.data_ptr(), out_p.stride(0), out_p.stride(1), out_p.stride(2),
        out_c.data_ptr(), out_c.stride(0), out_c.stride(1),
        b, h, n, d, float(scale_log2), cuda_kernels.stream_of(qp),
    )
    cuda_kernels.check(code, "cls_split_attention")


def cls_split_attention_parts(
    qp: torch.Tensor,  # [B, H, N, D] patch queries, PRE-SCALED
    kp: torch.Tensor,  # [B, H, N, D]
    vp: torch.Tensor,
    qc: torch.Tensor,  # [B, H, 1, D] cls query, PRE-SCALED
    kc: torch.Tensor,  # [B, H, 1, D]
    vc: torch.Tensor,
):
    """Exact attention for ViT's [cls + N patches] tokens; returns
    ``(out_cls [B, H, 1, D], out_patches [B, H, N, D])``.

    CPU tensors take the plain version (the JAX package's fallback). CUDA
    tensors make one launch of the cls-split kernel, which computes the
    patch rows and the cls row; it writes ``out_patches`` as a view of a
    contiguous ``[B, N, H, D]`` buffer, so
    ``out_patches.transpose(1, 2).reshape(B, N, H * D)`` is free."""
    if _device_kind(qp) == "cpu":
        return _cls_split_attention_plain(qp, kp, vp, qc, kc, vc)
    _check_operands(qp, kp, vp, qc, kc, vc)
    b, h, n, d = qp.shape
    out_p = _bhsd(torch.empty((b, n, h, d), dtype=qp.dtype, device=qp.device))
    out_c = _bhsd(torch.empty((b, 1, h, d), dtype=qp.dtype, device=qp.device))
    _launch_cls_split(qp, kp, vp, qc, kc, vc, out_c, out_p)
    cls_split_attention_parts.launches += 1
    return out_c, out_p


cuda_kernels.launch_counter(cls_split_attention_parts,
                            r"\battention_kernel<\d+,\s*false,\s*true>")


def cls_split_attention(qp, kp, vp, qc, kc, vc) -> torch.Tensor:
    """Concatenated convenience form of ``cls_split_attention_parts``
    (:393-401): ``[B, H, 1 + N, D]`` with the cls row first (the model's
    token order). The serving tower uses the parts form (no concat copy)."""
    out_c, out_p = cls_split_attention_parts(qp, kp, vp, qc, kc, vc)
    return torch.cat([out_c, out_p], dim=2)


def _cls_split_attention_scaled_plain(q, k, v, scale: float):
    """Plain softmax attention of all 1 + N rows over all 1 + N keys with
    ``scale``: the function of ``scripts/bench_cls_split_attention.py``'s
    patch-row kernel and ``jax.nn.softmax`` cls row (:99-107)."""
    return _bhsd(multi_head_attention(_bhsd(q), _bhsd(k), _bhsd(v), scale=scale))


def cls_split_attention_scaled(
    q: torch.Tensor,  # [B, H, 1 + N, D], cls at index 0, NOT pre-scaled
    k: torch.Tensor,
    v: torch.Tensor,
    true_head_dim: int,
) -> torch.Tensor:
    """Attention over ``[cls + N patches]`` with the explicit softmax scale
    ``true_head_dim**-0.5``; returns ``[B, H, 1 + N, D]``. Port of
    ``cls_split_attention`` in ``scripts/bench_cls_split_attention.py``
    (:61-108), whose ``_cls_kernel`` multiplies the scores by the scale and
    runs ``exp``.

    CPU tensors take ``_cls_split_attention_scaled_plain``. CUDA tensors
    make one launch of the cls-split kernel with
    ``scale_log2 = scale * log2(e)`` on the ``[:, :, 1:]`` patch views and
    the ``[:, :, :1]`` cls views (no copy); it writes all ``1 + N`` rows into
    one ``[B, 1 + N, H, D]`` buffer, so no concatenation copy is made."""
    scale = true_head_dim ** -0.5
    if _device_kind(q) == "cpu":
        return _cls_split_attention_scaled_plain(q, k, v, scale)
    b, h, s, d = q.shape
    qp, kp, vp = (t[:, :, 1:] for t in (q, k, v))
    qc, kc, vc = (t[:, :, :1] for t in (q, k, v))
    _check_operands(qp, kp, vp, qc, kc, vc)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    _launch_cls_split(qp, kp, vp, qc, kc, vc, _bhsd(out[:, :1]), _bhsd(out[:, 1:]),
                      scale * CLS_SPLIT_Q_PREMUL_LOG2E)
    cls_split_attention_scaled.launches += 1
    return _bhsd(out)


cuda_kernels.launch_counter(cls_split_attention_scaled,
                            r"\battention_kernel<\d+,\s*true,\s*true>")
