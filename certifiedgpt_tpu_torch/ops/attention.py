"""Attention compute ops.

Port of ``certifiedgpt_tpu/ops/attention.py``. ``multi_head_attention`` serves
the Q-Former, the decoder and the ViT's plain path; ``multi_head_attention_kv8``
is the same numerics over an int8 KV cache. Both share the masked-softmax core.
As in the JAX package, products take bf16 (or f32) operands with f32
accumulation: the operands are upcast to f32 here, which gives the same
values as JAX's ``preferred_element_type=float32`` (bf16 products are exact
in f32). Shapes follow [batch, seq, heads, head_dim].

``multi_head_attention_kv8`` is a hand-written CUDA kernel on the card
(``csrc/attention_kv8.cu``), which dequantizes the cache inside the kernel:
the prefill on the tensor cores, f32 queries of several rows and prefills
over longer caches a warp a query row; CPU tensors take its plain version,
``_multi_head_attention_kv8_plain``. ``decode_attention_kv8`` is the decode
step's (one query row): the step's k and v rows quantized into the int8
cache and the attention over it in one launch
(``csrc/attention_kv8_decode.cu``); its plain version is the quantization,
the slice writes and ``_multi_head_attention_kv8_plain``. Each wrapper's
``launches`` counts its kernel's launches, and
``multi_head_attention_kv8.tensor_core_launches`` those of the tensor-core
instance.
"""

from __future__ import annotations

from typing import Optional

import torch

from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops import quantization as Q

_F32_MIN = torch.finfo(torch.float32).min
_F32_TINY = torch.finfo(torch.float32).tiny


def _masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 max-shifted softmax over the last axis, True = keep, with the
    tiny-guard renormalization: a fully masked row gives zeros, not NaN."""
    if mask is not None:
        logits = torch.where(mask, logits, _F32_MIN)
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    return weights / weights.sum(dim=-1, keepdim=True).clamp_min(_F32_TINY)


def multi_head_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, H_kv, Dh]
    v: torch.Tensor,  # [B, Sk, H_kv, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]; True = keep
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention with an f32 softmax; grouped-query
    heads are repeated to match. Returns [B, Sq, H, Dh] in q's dtype."""
    h_q, h_kv = q.shape[2], k.shape[2]
    if h_kv != h_q:
        rep = h_q // h_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = _masked_softmax(logits * scale, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


#: most warps a block of the kv8 kernel (csrc/attention_kv8.cu kMaxWarps)
KV8_MAX_WARPS = 8
#: the head_dim and the most cached positions of the kv8 kernel's
#: tensor-core instance (csrc/attention_kv8.cu kMmaDh, kMmaMaxKeys)
KV8_MMA_HEAD_DIM = 128
KV8_MMA_MAX_KEYS = 256
#: the kv8 launcher's code for a cache too long for its shared memory
#: (csrc/attention_kv8.cu kCacheTooLong)
_KV8_CACHE_TOO_LONG = -1


def multi_head_attention_kv8(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    kq8: torch.Tensor,  # [B, Sk, H_kv, Dh] int8
    ks: torch.Tensor,  # [B, Sk, H_kv, 1] f32 per-row scales
    vq8: torch.Tensor,  # [B, Sk, H_kv, Dh] int8
    vs: torch.Tensor,  # [B, Sk, H_kv, 1] f32
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, 1, Sq, Sk]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over an int8 KV cache with the per-row scales applied to
    the score and weight tensors (``dequant(kq8) = kq8 * ks`` commutes with
    both contractions), grouped-query heads folded as the JAX function
    folds them (``h // h_kv``). Returns [B, Sq, H, Dh] in q's dtype.

    Replaces the XLA-fused ``multi_head_attention_kv8`` of the JAX package
    (certifiedgpt_tpu/ops/attention.py:76). CPU tensors take
    ``_multi_head_attention_kv8_plain``; bf16 and f32 CUDA tensors launch
    ``cgpt_attention_kv8`` (csrc/attention_kv8.cu), which reads the int8
    cache and makes no dequantized copy. bf16 queries of more than one row
    (the prefill) at head_dim 128 over at most 256 cached positions run its
    tensor-core instance, with the row of logits in registers; f32 queries,
    longer caches and a lone query row run its warp-a-row instance (the
    decoder's decode step takes ``decode_attention_kv8`` instead). The
    kernel takes a head-agnostic mask (dimension 1 of size 1) and raises on
    a per-head one, and on a cache too long for the warp-a-row instance's
    rows of logits in shared memory."""
    if q.device.type == "cpu":
        return _multi_head_attention_kv8_plain(q, kq8, ks, vq8, vs, mask, scale)
    b, sq, h, dh = q.shape
    t, h_kv = kq8.shape[1], kq8.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or kq8.dtype != torch.int8 \
            or vq8.dtype != torch.int8:
        raise TypeError(f"multi_head_attention_kv8: the CUDA kernel takes bf16 or f32 q and an "
                        f"int8 cache, got {q.dtype}, {kq8.dtype}, {vq8.dtype}")
    if vq8.shape != kq8.shape or kq8.shape[0] != b or kq8.shape[3] != dh or h % h_kv:
        raise ValueError(f"multi_head_attention_kv8: q {tuple(q.shape)} against a cache "
                         f"{tuple(kq8.shape)} / {tuple(vq8.shape)}")
    if dh % 16 or dh > 256:
        raise ValueError(f"multi_head_attention_kv8: head_dim {dh} must be a multiple of 16 "
                         "up to 256")
    if vq8.stride() != kq8.stride() or kq8.stride(3) != 1 or any(
            st % 16 for st in kq8.stride()[:3]):
        raise ValueError("multi_head_attention_kv8: k and v must share strides with "
                         "contiguous, 16-byte aligned rows")
    ks3, vs3 = ks[..., 0], vs[..., 0]
    if ks3.shape != (b, t, h_kv) or vs3.stride() != ks3.stride():
        raise ValueError(f"multi_head_attention_kv8: scales {tuple(ks.shape)} / "
                         f"{tuple(vs.shape)} must be [{b}, {t}, {h_kv}, 1] with equal strides")
    if ks3.dtype != torch.float32 or vs3.dtype != torch.float32:
        raise TypeError("multi_head_attention_kv8: the cache scales must be f32")
    tensor_cores = (q.dtype == torch.bfloat16 and sq > 1 and dh == KV8_MMA_HEAD_DIM
                    and t <= KV8_MMA_MAX_KEYS)
    if q.stride(3) != 1 or (tensor_cores and (
            q.data_ptr() % 16 or any(st % 8 for st in q.stride()[:3]))):
        # the tensor-core instance copies q rows 16 bytes at a time
        q = q.clone(memory_format=torch.contiguous_format)
    mask_ptr, mask_strides = None, (0, 0, 0)
    if mask is not None:
        if mask.dim() != 4 or mask.shape[1] != 1:
            raise ValueError(f"multi_head_attention_kv8: the CUDA kernel takes a head-agnostic "
                             f"mask [B|1, 1, Sq|1, Sk], got {tuple(mask.shape)}")
        m3 = mask.to(torch.bool).expand(b, 1, sq, t)[:, 0]
        mask_ptr, mask_strides = m3.data_ptr(), m3.stride()
    warps = min(KV8_MAX_WARPS, (h // h_kv) * sq)
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        kq8.data_ptr(), vq8.data_ptr(), *kq8.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, sq, h, h_kv, t, dh, float(scale), warps, int(q.dtype == torch.float32),
        int(tensor_cores), cuda_kernels.stream_of(q))
    if code == _KV8_CACHE_TOO_LONG:
        raise ValueError(f"multi_head_attention_kv8: a cache of {t} positions does not fit "
                         f"the kernel's shared memory ({warps} rows of {dh} + {t} floats)")
    multi_head_attention_kv8.launches += 1
    multi_head_attention_kv8.tensor_core_launches += tensor_cores
    cuda_kernels.check(code, "multi_head_attention_kv8")
    return out


multi_head_attention_kv8.launches = 0
#: the launches (of ``launches``) that ran the tensor-core instance
multi_head_attention_kv8.tensor_core_launches = 0


def _multi_head_attention_kv8_plain(q, kq8, ks, vq8, vs, mask=None, scale=None):
    """``multi_head_attention_kv8`` in plain PyTorch: the JAX function's
    arithmetic, with the int8 cache upcast to f32 (exact)."""
    b, sq, h, dh = q.shape
    h_kv = kq8.shape[2]
    g = h // h_kv
    if scale is None:
        scale = dh ** -0.5
    # [B, Sk, H_kv, 1] -> [B, H_kv, 1, 1, Sk] to broadcast over (G, Sq)
    ks_b = ks[..., 0].transpose(1, 2)[:, :, None, None, :]
    vs_b = vs[..., 0].transpose(1, 2)[:, :, None, None, :]

    qg = q.reshape(b, sq, h_kv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kq8.float())
    logits = logits * ks_b * scale
    if mask is not None:
        # lift [B|1, H|1, Sq, Sk] to the grouped [.., H_kv, G, Sq, Sk]
        if mask.shape[1] == 1:
            mask = mask[:, :, None]
        else:
            mask = mask.reshape(mask.shape[0], h_kv, g, sq, -1)
    weights = _masked_softmax(logits, mask)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", (weights * vs_b).to(q.dtype).float(), vq8.float()
    )
    return out.reshape(b, sq, h, dh).to(q.dtype)


#: query heads a kv head that the decode kernel takes (its instances)
KV8_DECODE_GROUPS = (1, 2, 4, 8)


def decode_attention_kv8(
    q: torch.Tensor,  # [B, 1, H, Dh] the step's rotated queries
    k: torch.Tensor,  # [B, 1, H_kv, Dh] the step's rotated keys
    v: torch.Tensor,  # [B, 1, H_kv, Dh] the step's values
    cache: dict,  # "k", "v" int8 [B, T, H_kv, Dh]; "k_scale", "v_scale" f32 [B, T, H_kv, 1]
    offset: int,  # the cache slot of the step
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, 1, 1, T]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step over the int8 KV cache: quantizes the step's k and v
    rows into slot ``offset`` of the cache (in place; codes and scales bit
    for bit ``quantize_rows``'), then attends over the whole cache as
    ``multi_head_attention_kv8`` does. Returns [B, 1, H, Dh] in q's dtype.

    Replaces the decode's quantize_rows of k and v, the four cache writes
    and ``multi_head_attention_kv8`` of the JAX package's cached block
    (certifiedgpt_tpu/models/llama.py:243-270), which XLA runs as one
    program. CPU tensors take ``_decode_attention_kv8_plain`` (that
    sequence); bf16 and f32 CUDA tensors launch ``cgpt_attention_kv8_decode``
    (csrc/attention_kv8_decode.cu), one launch that writes the cache and
    attends. The kernel takes a head-agnostic mask and ``H / H_kv`` in
    ``KV8_DECODE_GROUPS``, and raises otherwise."""
    t = cache["k"].shape[1]
    if q.shape[1] != 1 or k.shape[1] != 1 or v.shape != k.shape:
        raise ValueError(f"decode_attention_kv8: one query row, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 <= offset < t:
        raise ValueError(f"decode_attention_kv8: offset {offset} outside a cache of {t} slots")
    if q.device.type == "cpu":
        return _decode_attention_kv8_plain(q, k, v, cache, offset, mask, scale)
    b, _, h, dh = q.shape
    kc, vc = cache["k"], cache["v"]
    h_kv = kc.shape[2]
    ks3, vs3 = cache["k_scale"][..., 0], cache["v_scale"][..., 0]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype or kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise TypeError(f"decode_attention_kv8: the CUDA kernel takes bf16 or f32 q, k, v and "
                        f"an int8 cache, got {q.dtype}, {k.dtype}, {v.dtype}, {kc.dtype}")
    if vc.shape != kc.shape or kc.shape[0] != b or kc.shape[3] != dh \
            or k.shape != (b, 1, h_kv, dh) or h % h_kv or h // h_kv not in KV8_DECODE_GROUPS:
        raise ValueError(f"decode_attention_kv8: q {tuple(q.shape)}, k {tuple(k.shape)} against "
                         f"a cache {tuple(kc.shape)}: the kernel takes {KV8_DECODE_GROUPS} "
                         "query heads a kv head")
    if dh % 16 or dh > 256:
        raise ValueError(f"decode_attention_kv8: head_dim {dh} must be a multiple of 16 up "
                         "to 256")
    if vc.stride() != kc.stride() or kc.stride(3) != 1 or any(
            st % 16 for st in kc.stride()[:3]):
        raise ValueError("decode_attention_kv8: the cache's k and v must share strides with "
                         "contiguous, 16-byte aligned rows")
    if ks3.shape != (b, t, h_kv) or vs3.stride() != ks3.stride() \
            or ks3.dtype != torch.float32 or vs3.dtype != torch.float32:
        raise ValueError(f"decode_attention_kv8: scales {tuple(cache['k_scale'].shape)} must be "
                         f"f32 [{b}, {t}, {h_kv}, 1] with equal strides")
    # the kernel copies q, k and v rows 16 bytes at a time
    q, k, v = (x if x.stride(3) == 1 and x.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in x.stride()[:3])
               else x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    if v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    mask_ptr, mask_strides = None, (0, 0)
    if mask is not None:
        if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(f"decode_attention_kv8: the CUDA kernel takes a head-agnostic "
                             f"mask [B|1, 1, 1, T], got {tuple(mask.shape)}")
        m2 = mask.to(torch.bool).expand(b, 1, 1, t)[:, 0, 0]
        mask_ptr, mask_strides = m2.data_ptr(), m2.stride()
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8_decode(
        q.data_ptr(), q.stride(0), q.stride(2),
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(2),
        kc.data_ptr(), vc.data_ptr(), *kc.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, h, h_kv, t, dh, offset, float(scale), int(q.dtype == torch.float32),
        cuda_kernels.stream_of(q))
    if code == _KV8_CACHE_TOO_LONG:
        raise ValueError(f"decode_attention_kv8: a cache of {t} positions does not fit the "
                         "kernel's shared memory")
    decode_attention_kv8.launches += 1
    cuda_kernels.check(code, "decode_attention_kv8")
    return out


decode_attention_kv8.launches = 0


def _decode_attention_kv8_plain(q, k, v, cache, offset, mask=None, scale=None):
    """``decode_attention_kv8`` in plain PyTorch: the decoder block's
    sequence before the kernel, as the JAX package runs it: the step's k
    and v rows quantized, written to slot ``offset`` of the four cache
    tensors, then ``_multi_head_attention_kv8_plain`` over the cache."""
    kq, ks = Q._quantize_rows_plain(k)
    vq, vs = Q._quantize_rows_plain(v)
    at = slice(offset, offset + 1)
    cache["k"][:, at] = kq
    cache["v"][:, at] = vq
    cache["k_scale"][:, at] = ks
    cache["v_scale"][:, at] = vs
    return _multi_head_attention_kv8_plain(q, cache["k"], cache["k_scale"], cache["v"],
                                           cache["v_scale"], mask, scale)
