"""Attention compute ops.

Port of ``certifiedgpt_tpu/ops/attention.py``. ``multi_head_attention`` serves
the Q-Former, the decoder and the ViT's plain path; ``multi_head_attention_kv8``
is the same numerics over an int8 KV cache. Both share the masked-softmax core.
As in the JAX package, products take bf16 (or f32) operands with f32
accumulation: the operands are upcast to f32 here, which gives the same
values as JAX's ``preferred_element_type=float32`` (bf16 products are exact
in f32). Shapes follow [batch, seq, heads, head_dim].

``multi_head_attention_kv8`` is a hand-written CUDA kernel on the card,
which dequantizes the cache inside the kernel: bf16 queries of several rows
at head_dim 128 run ``csrc/attention_kv8_prefill.cu`` (writing nothing),
f32 queries, a lone query row and other head widths the warp-a-row kernel
of ``csrc/attention_kv8.cu``; CPU tensors take its plain version,
``_multi_head_attention_kv8_plain``. ``prefill_attention_kv8`` is the
prefill's: the S new k and v rows quantized into the int8 cache and the
attention over it in one launch (``csrc/attention_kv8_prefill.cu``).
``decode_attention_kv8`` is the decode step's (one query row), the same in
one launch of ``csrc/attention_kv8_decode.cu``. The plain versions of both
are the quantization, the slice writes and
``_multi_head_attention_kv8_plain``. Each wrapper's ``launches`` counts its
kernel's launches: ``multi_head_attention_kv8.launches`` the warp-a-row
kernel's, ``prefill_attention_kv8.launches`` every launch of the prefill
kernel, from either entry.
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


#: most warps a block of the warp-a-row kv8 kernel (csrc/attention_kv8.cu kMaxWarps)
KV8_MAX_WARPS = 8
#: the head_dim of the prefill's kv8 kernel (csrc/attention_kv8_prefill.cu kDh)
KV8_PREFILL_HEAD_DIM = 128
#: the kv8 launchers' code for a cache too long for their shared memory
#: (kCacheTooLong of csrc/attention_kv8.cu and csrc/attention_kv8_prefill.cu)
_KV8_CACHE_TOO_LONG = -1


def _takes_prefill_kernel(q: torch.Tensor, dh: int) -> bool:
    """bf16 queries of several rows at head_dim 128: the shapes that
    ``csrc/attention_kv8_prefill.cu`` takes."""
    return q.dtype == torch.bfloat16 and q.shape[1] > 1 and dh == KV8_PREFILL_HEAD_DIM


def _check_cache(name, b, h, dh, kq8, vq8, ks, vs):
    """The int8 cache's and its scales' dtypes, shapes and strides as the
    kernels take them; returns the scales as [B, T, H_kv] views."""
    h_kv, t = kq8.shape[2], kq8.shape[1]
    if kq8.dtype != torch.int8 or vq8.dtype != torch.int8:
        raise TypeError(f"{name}: the CUDA kernel takes an int8 cache, got {kq8.dtype}, "
                        f"{vq8.dtype}")
    if vq8.shape != kq8.shape or kq8.shape[0] != b or kq8.shape[3] != dh or h % h_kv:
        raise ValueError(f"{name}: {h} query heads of {dh} against a cache "
                         f"{tuple(kq8.shape)} / {tuple(vq8.shape)}")
    if dh % 16 or dh > 256:
        raise ValueError(f"{name}: head_dim {dh} must be a multiple of 16 up to 256")
    if vq8.stride() != kq8.stride() or kq8.stride(3) != 1 or any(
            st % 16 for st in kq8.stride()[:3]):
        raise ValueError(f"{name}: k and v must share strides with contiguous, 16-byte "
                         "aligned rows")
    ks3, vs3 = ks[..., 0], vs[..., 0]
    if ks3.shape != (b, t, h_kv) or vs3.stride() != ks3.stride():
        raise ValueError(f"{name}: scales {tuple(ks.shape)} / {tuple(vs.shape)} must be "
                         f"[{b}, {t}, {h_kv}, 1] with equal strides")
    if ks3.dtype != torch.float32 or vs3.dtype != torch.float32:
        raise TypeError(f"{name}: the cache scales must be f32")
    return ks3, vs3


def _mask_bytes(name, mask, b, sq, t):
    """A head-agnostic mask [B|1, 1, Sq|1, T] as the kernels read it: its
    data pointer and (b, s, t) strides in bytes (None, zeros: no mask)."""
    if mask is None:
        return None, (0, 0, 0)
    if mask.dim() != 4 or mask.shape[1] != 1:
        raise ValueError(f"{name}: the CUDA kernel takes a head-agnostic mask "
                         f"[B|1, 1, Sq|1, T], got {tuple(mask.shape)}")
    m3 = mask.to(torch.bool).expand(b, 1, sq, t)[:, 0]
    return m3.data_ptr(), m3.stride()


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
    ``_multi_head_attention_kv8_plain``. CUDA tensors launch a kernel that
    reads the int8 cache and makes no dequantized copy, chosen by dtype and
    shape: bf16 queries of more than one row at head_dim 128 launch
    ``cgpt_attention_kv8_prefill`` (csrc/attention_kv8_prefill.cu, counted
    in ``prefill_attention_kv8.launches``) with no rows to write; f32
    queries, a lone query row and other head widths launch the warp-a-row
    ``cgpt_attention_kv8`` (csrc/attention_kv8.cu, counted in
    ``multi_head_attention_kv8.launches``), whose rows of logits live in
    shared memory. The decoder's decode step takes ``decode_attention_kv8``
    and its prefill ``prefill_attention_kv8`` instead. The kernels take a
    head-agnostic mask (dimension 1 of size 1) and raise on a per-head one,
    and on a cache too long for their shared memory."""
    if q.device.type == "cpu":
        return _multi_head_attention_kv8_plain(q, kq8, ks, vq8, vs, mask, scale)
    b, sq, h, dh = q.shape
    t = kq8.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"multi_head_attention_kv8: the CUDA kernel takes bf16 or f32 q, got "
                        f"{q.dtype}")
    ks3, vs3 = _check_cache("multi_head_attention_kv8", b, h, dh, kq8, vq8, ks, vs)
    if scale is None:
        scale = dh ** -0.5
    if _takes_prefill_kernel(q, dh):
        return _launch_prefill_kv8(q, None, None, kq8, vq8, ks3, vs3, t, mask, scale)
    if q.stride(3) != 1:
        q = q.clone(memory_format=torch.contiguous_format)
    mask_ptr, mask_strides = _mask_bytes("multi_head_attention_kv8", mask, b, sq, t)
    warps = min(KV8_MAX_WARPS, (h // kq8.shape[2]) * sq)
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        kq8.data_ptr(), vq8.data_ptr(), *kq8.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, sq, h, kq8.shape[2], t, dh, float(scale), warps, int(q.dtype == torch.float32),
        cuda_kernels.stream_of(q))
    if code == _KV8_CACHE_TOO_LONG:
        raise ValueError(f"multi_head_attention_kv8: a cache of {t} positions does not fit "
                         f"the kernel's shared memory ({warps} rows of {dh} + {t} floats)")
    multi_head_attention_kv8.launches += 1
    cuda_kernels.check(code, "multi_head_attention_kv8")
    return out


multi_head_attention_kv8.launches = 0


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


def prefill_attention_kv8(
    q: torch.Tensor,  # [B, S, H, Dh] the prefill's rotated queries
    k: torch.Tensor,  # [B, S, H_kv, Dh] its rotated keys
    v: torch.Tensor,  # [B, S, H_kv, Dh] its values
    cache: dict,  # "k", "v" int8 [B, T, H_kv, Dh]; "k_scale", "v_scale" f32 [B, T, H_kv, 1]
    offset: int,  # the cache slot of the first new row
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, 1, S, T]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The prefill over the int8 KV cache: quantizes the S new k and v rows
    into slots ``[offset, offset + S)`` of the cache (in place; codes and
    scales bit for bit ``quantize_rows``'), then attends over the whole
    cache as ``multi_head_attention_kv8`` does. Returns [B, S, H, Dh] in
    q's dtype.

    Replaces the prefill's quantize_rows of k and v, the four cache writes
    and ``multi_head_attention_kv8`` of the JAX package's cached block
    (certifiedgpt_tpu/models/llama.py:243-270), which XLA runs as one
    program. CPU tensors take ``_prefill_attention_kv8_plain`` (that
    sequence). On CUDA the choice is by dtype and shape: bf16 q, k and v of
    more than one row at head_dim 128 launch ``cgpt_attention_kv8_prefill``
    (csrc/attention_kv8_prefill.cu), one launch that writes the cache and
    attends, at any cache length and any ``H / H_kv``; anything else (f32,
    which serves the tiny and f32 configurations only; one row; another
    head width) runs the sequence itself: ``quantize_rows``' kernel on k
    and v, the four slice writes and ``multi_head_attention_kv8``. The
    kernel takes a head-agnostic mask and raises otherwise; a build or
    launch failure raises."""
    t = cache["k"].shape[1]
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"prefill_attention_kv8: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    s = q.shape[1]
    if offset < 0 or offset + s > t:
        raise ValueError(f"prefill_attention_kv8: {s} rows at offset {offset} outside a cache "
                         f"of {t} slots")
    if q.device.type == "cpu":
        return _prefill_attention_kv8_plain(q, k, v, cache, offset, mask, scale)
    b, _, h, dh = q.shape
    if not (_takes_prefill_kernel(q, dh) and k.dtype == q.dtype and v.dtype == q.dtype):
        kq, ks = Q.quantize_rows(k)
        vq, vs = Q.quantize_rows(v)
        at = slice(offset, offset + s)
        cache["k"][:, at] = kq
        cache["v"][:, at] = vq
        cache["k_scale"][:, at] = ks
        cache["v_scale"][:, at] = vs
        return multi_head_attention_kv8(q, cache["k"], cache["k_scale"], cache["v"],
                                        cache["v_scale"], mask, scale)
    kc, vc = cache["k"], cache["v"]
    if k.shape != (b, s, kc.shape[2], dh):
        raise ValueError(f"prefill_attention_kv8: k {tuple(k.shape)} against a cache "
                         f"{tuple(kc.shape)}")
    ks3, vs3 = _check_cache("prefill_attention_kv8", b, h, dh, kc, vc, cache["k_scale"],
                            cache["v_scale"])
    if scale is None:
        scale = dh ** -0.5
    # the kernel's tensor copies read the new rows 16 bytes at a time
    k, v = (x if x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in x.stride()[:3])
            else x.clone(memory_format=torch.contiguous_format) for x in (k, v))
    return _launch_prefill_kv8(q, k, v, kc, vc, ks3, vs3, offset, mask, scale)


prefill_attention_kv8.launches = 0
# the counter's owner, whatever a caller later binds to the module's name
_prefill_counter = prefill_attention_kv8


def _launch_prefill_kv8(q, k, v, kc, vc, ks3, vs3, offset, mask, scale):
    """One launch of ``cgpt_attention_kv8_prefill``: with new rows ``k``,
    ``v`` it writes them at ``offset`` (``k`` None: it writes nothing), then
    attends over the whole cache. The caller has checked the cache."""
    b, sq, h, dh = q.shape
    t, h_kv = kc.shape[1], kc.shape[2]
    if q.stride(3) != 1 or q.data_ptr() % 16 or any(st % 8 for st in q.stride()[:3]):
        # the kernel copies q's rows 16 bytes at a time
        q = q.clone(memory_format=torch.contiguous_format)
    mask_ptr, mask_strides = _mask_bytes("prefill_attention_kv8", mask, b, sq, t)
    sn = 0 if k is None else k.shape[1]
    new = (None, 0, 0, 0) if k is None else (k.data_ptr(), k.stride(0), k.stride(1), k.stride(2))
    newv = (None, 0, 0, 0) if v is None else (v.data_ptr(), v.stride(0), v.stride(1),
                                                v.stride(2))
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8_prefill(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2), *new, *newv,
        kc.data_ptr(), vc.data_ptr(), *kc.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, sq, h, h_kv, t, dh, offset if k is not None else t, sn, float(scale),
        cuda_kernels.stream_of(q))
    if code == _KV8_CACHE_TOO_LONG:
        raise ValueError(f"prefill_attention_kv8: a cache of {t} positions does not fit the "
                         "kernel's shared memory")
    _prefill_counter.launches += 1
    cuda_kernels.check(code, "prefill_attention_kv8")
    return out


def prefill_kv8_plan(b: int, sq: int, h: int, h_kv: int, t: int, offset: int, sn: int) -> dict:
    """The prefill kernel's launch plan on the current card (a host query)
    for ``sn`` new rows at ``offset`` (0 and ``t``: no rows to write): warps
    a block, units an item, shared bytes a block, blocks an SM, the K tiles a
    unit may keep from its first pass for its second."""
    import ctypes

    out = (ctypes.c_int * 5)()
    code = cuda_kernels.build().lib.cgpt_attention_kv8_prefill_plan(b, sq, h, h_kv, t, offset,
                                                                    sn, out)
    cuda_kernels.check(code, "prefill_kv8_plan")
    return dict(zip(("warps", "units", "smem_bytes", "blocks_per_sm", "cached_tiles"), out))


def _prefill_attention_kv8_plain(q, k, v, cache, offset, mask=None, scale=None):
    """``prefill_attention_kv8`` in plain PyTorch: the decoder block's
    sequence before the kernel, as the JAX package runs it: the S new k and
    v rows quantized, written to slots ``[offset, offset + S)`` of the four
    cache tensors, then ``_multi_head_attention_kv8_plain`` over the
    cache."""
    kq, ks = Q._quantize_rows_plain(k)
    vq, vs = Q._quantize_rows_plain(v)
    at = slice(offset, offset + k.shape[1])
    cache["k"][:, at] = kq
    cache["v"][:, at] = vq
    cache["k_scale"][:, at] = ks
    cache["v_scale"][:, at] = vs
    return _multi_head_attention_kv8_plain(q, cache["k"], cache["k_scale"], cache["v"],
                                           cache["v_scale"], mask, scale)
