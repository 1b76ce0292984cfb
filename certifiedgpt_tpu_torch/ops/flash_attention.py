"""cls-split ViT attention: EVA ViT's [cls + N patches] tokens.

Port of ``cls_split_attention_parts`` of
``certifiedgpt_tpu/ops/flash_attention.py`` (:293). The patch block
(N = 1024 at 448 px) attends over the N patch keys plus the single cls
key, which enters each row's softmax as a rank-1 term; the single cls
query row is plain torch. The Pallas TPU kernel ``_cls_split_kernel``
(:258) becomes the CUDA kernel of ``csrc/cls_split_attention.cu``.

PRE-SCALING CONTRACT (as in the JAX package): the q operands carry
``head_dim**-0.5 * log2(e)`` (``CLS_SPLIT_Q_PREMUL_LOG2E``) folded into the
qkv weights, so the softmax runs on ``exp2``; the factor cancels in the
normalization.

Head padding: the TPU pads dh = 88 to 128 lanes in device memory. The port
does not: operands are ``[B, H, N, D]`` at the true head dim (strided views
of the qkv matmul output are taken as they are), and the kernel pads to 96 (a
multiple of the MMA k-step 16) in shared memory only (see the source note).
"""

from __future__ import annotations

import math

import torch

from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops.attention import multi_head_attention

#: factor producers fold into q so the kernel can exp2 without rescaling
CLS_SPLIT_Q_PREMUL_LOG2E = float(math.log2(math.e))

#: query and key tile of the CUDA kernel; N must be a multiple of it
KERNEL_TILE = 64

#: head dim the CUDA kernel pads to in shared memory (dh = 88 of EVA ViT-g);
#: narrower multiples of 8 are zero-padded, wider ones are refused
KERNEL_HEAD_DIM = 96


def _cls_split_attention_plain(qp, kp, vp, qc, kc, vc):
    """The JAX package's exact fallback (:330-341): reassemble the cls and
    patch parts and run plain attention with ``scale = ln 2``, which undoes
    the log2(e) pre-scale (softmax(s * ln2) == softmax2(s))."""
    bshd = lambda x: x.transpose(1, 2)  # noqa: E731
    q = torch.cat([qc, qp], dim=2)
    k = torch.cat([kc, kp], dim=2)
    v = torch.cat([vc, vp], dim=2)
    out = multi_head_attention(bshd(q), bshd(k), bshd(v), scale=math.log(2.0))
    out = out.transpose(1, 2)
    return out[:, :, :1], out[:, :, 1:]


def _bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32; bf16 operands
    stay bf16 (``out_dtype`` is a CUDA-only overload)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def _cls_query_row(qc, kp, vp, kc, vc):
    """The single cls query over [cls + N] keys (log2 domain), as the CUDA
    path computes it: the JAX package's plain-XLA cls row (:371-390), with
    bf16 operands, f32 accumulation and f32 scores as in its
    ``preferred_element_type=f32`` einsums.

    Both products are batched over B with all heads at once, so that K and
    V are read in place (a ``[B, N, H*D]`` view of the fused qkv output)
    and never upcast or copied: the scores come from K against a
    block-diagonal ``[H*D, H]`` matrix of the cls queries, and P.V keeps
    the diagonal ``[D]`` blocks of ``[H, H*D]``. The off-diagonal work is
    H times the needed, a few GFLOP at the main path's shapes."""
    b, h, n, d = kp.shape
    k2 = kp.transpose(1, 2).reshape(b, n, h * d)
    v2 = vp.transpose(1, 2).reshape(b, n, h * d)
    eye = torch.eye(h, dtype=qc.dtype, device=qc.device)
    q_blocks = (qc[:, :, 0, :, None] * eye[None, :, None, :]).reshape(b, h * d, h)
    s_p = _bmm_f32(k2, q_blocks).transpose(1, 2)  # [B, H, N]
    s_cc = (qc[:, :, 0].float() * kc[:, :, 0].float()).sum(dim=-1, keepdim=True)
    m = torch.maximum(s_p.amax(dim=-1, keepdim=True), s_cc)
    w_p = torch.exp2(s_p - m)
    w_c = torch.exp2(s_cc - m)
    denom = w_p.sum(dim=-1, keepdim=True) + w_c
    pv = _bmm_f32(w_p.to(vp.dtype), v2)  # [B, H, H*D]
    pv = pv.view(b, h, h, d).diagonal(dim1=1, dim2=2).transpose(1, 2)  # [B, H, D]
    out = (pv + w_c * vc[:, :, 0].float()) / denom
    return out[:, :, None].to(qc.dtype)


def _check_operands(qp, kp, vp, qc, kc, vc):
    b, h, n, d = qp.shape
    for name, t in (("qp", qp), ("kp", kp), ("vp", vp)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"cls_split_attention_parts: {name} must be bf16")
        if t.shape != qp.shape or t.stride() != qp.stride():
            raise ValueError(
                "cls_split_attention_parts: qp, kp, vp need one shape and "
                f"one stride; {name} has {tuple(t.shape)} {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"cls_split_attention_parts: {name} is not 16-byte aligned")
    if qp.stride(3) != 1 or any(s % 8 for s in qp.stride()[:3]):
        raise ValueError(
            "cls_split_attention_parts: rows must be contiguous and 16-byte "
            f"aligned (strides multiples of 8), got {qp.stride()}"
        )
    if n % KERNEL_TILE or d % 8 or d > KERNEL_HEAD_DIM:
        raise ValueError(
            f"cls_split_attention_parts: needs N % {KERNEL_TILE} == 0 and "
            f"D a multiple of 8 up to {KERNEL_HEAD_DIM}, got N={n}, D={d}"
        )
    for name, t in (("kc", kc), ("vc", vc)):
        if t.dtype != torch.bfloat16 or t.shape != (b, h, 1, d) or t.stride(3) != 1:
            raise ValueError(
                f"cls_split_attention_parts: {name} must be bf16 [B, H, 1, D] "
                f"with contiguous rows, got {t.dtype} {tuple(t.shape)}"
            )
    if kc.stride() != vc.stride():
        raise ValueError("cls_split_attention_parts: kc and vc need one stride")


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
    tensors launch the cls-split kernel for the patch rows, which writes
    ``out_patches`` as a view of a ``[B, N, H, D]`` buffer, so
    ``out_patches.transpose(1, 2).reshape(B, N, H * D)`` is free."""
    if qp.device.type == "cpu":
        return _cls_split_attention_plain(qp, kp, vp, qc, kc, vc)
    if qp.device.type != "cuda":
        raise ValueError(f"unsupported device {qp.device}")
    _check_operands(qp, kp, vp, qc, kc, vc)
    out_p = _launch_patch_rows(qp, kp, vp, kc, vc)
    out_c = _cls_query_row(qc, kp, vp, kc, vc)
    return out_c, out_p


def _launch_patch_rows(qp, kp, vp, kc, vc) -> torch.Tensor:
    """The CUDA kernel on checked operands: the N patch rows only."""
    b, h, n, d = qp.shape
    out_p = torch.empty((b, n, h, d), dtype=qp.dtype, device=qp.device)
    out_p = out_p.transpose(1, 2)  # [B, H, N, D] view
    lib = cuda_kernels.build().lib
    code = lib.cgpt_cls_split_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        qp.stride(0), qp.stride(1), qp.stride(2),
        kc.data_ptr(), vc.data_ptr(), kc.stride(0), kc.stride(1),
        out_p.data_ptr(), out_p.stride(0), out_p.stride(1), out_p.stride(2),
        b, h, n, d, cuda_kernels.stream_of(qp),
    )
    cls_split_attention_parts.launches += 1
    cuda_kernels.check(code, "cls_split_attention_parts")
    return out_p


cls_split_attention_parts.launches = 0
