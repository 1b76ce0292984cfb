"""Attention compute ops.

Port of ``certifiedgpt_tpu/ops/attention.py``. ``multi_head_attention`` serves
the Q-Former, the decoder's cached calls without int8 KV and the ViT's plain
path; ``training_attention`` is the decoder's self-attention without a cache
(training and validation batches: causal, the keys' validity, packed
segments), differentiable, as hand-written kernels on the card
(``csrc/train_attention.cu``: the forward, and the backward as two kernels);
``multi_head_attention_kv8`` is the same numerics over an int8 KV cache. All
share the masked-softmax core.
As in the JAX package, products take bf16 (or f32) operands with f32
accumulation: the operands are upcast to f32 here, which gives the same
values as JAX's ``preferred_element_type=float32`` (bf16 products are exact
in f32). Shapes follow [batch, seq, heads, head_dim].

``multi_head_attention_kv8`` is a hand-written CUDA kernel on the card,
which dequantizes the cache inside the kernel; ``kv8_kernel`` names which:
bf16 queries of several rows at head_dim 128 run
``csrc/attention_kv8_prefill.cu``, a lone query row at 1, 2, 4 or 8 query
heads a kv head ``csrc/attention_kv8_decode.cu`` (both writing nothing),
anything else (f32 queries, other head widths, other groups) the tiled
kernel of ``csrc/attention_kv8.cu``; CPU tensors take its plain version,
``_multi_head_attention_kv8_plain``. ``prefill_attention_kv8`` is the
prefill's: the S new k and v rows quantized into the int8 cache and the
attention over it in one launch of the kernel ``kv8_kernel`` names.
``decode_attention_kv8`` is the decode step's (one query row), the same in
one launch of ``csrc/attention_kv8_decode.cu``. The plain versions of both
are the quantization, the slice writes and
``_multi_head_attention_kv8_plain``. Each kernel's launches are counted on
one wrapper, from whichever entry launched it:
``multi_head_attention_kv8.launches`` the tiled kernel's,
``prefill_attention_kv8.launches`` the prefill kernel's,
``decode_attention_kv8.launches`` the decode kernel's.
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


def training_mask(attention_mask: torch.Tensor, segment_ids: Optional[torch.Tensor], s: int,
                  device) -> torch.Tensor:
    """Causal ``[1, 1, S, S]`` and key validity ``[B, 1, 1, S]``, and with
    ``segment_ids`` the block diagonal ``[B, 1, S, S]``: a query sees a key
    only inside its own packed segment. Pad slots carry id 0 and end fully
    masked; the softmax's guard gives their rows zeros (and zero
    gradients), not NaN."""
    causal = torch.ones((s, s), dtype=torch.bool, device=device).tril()[None, None]
    mask = causal & attention_mask[:, None, None, :].bool()
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        mask = mask & same[:, None]
    return mask


def _training_attention_plain(q, k, v, attention_mask, segment_ids=None, scale=None):
    """``multi_head_attention`` under ``training_mask``'s dense mask (the
    JAX package's training forward), differentiable by autograd."""
    mask = training_mask(attention_mask, segment_ids, q.shape[1], q.device)
    return multi_head_attention(q, k, v, mask, scale)


#: the head widths of the training attention's kernels (csrc/train_attention.cu
#: instances: Vicuna-7B's 128, and the narrow test models')
TRAIN_ATTENTION_HEAD_DIMS = (16, 32, 64, 128)


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous on a 16-byte boundary."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _train_attention_args(q, k, v, attention_mask, segment_ids):
    """The kernels' operands: q, k, v contiguous, the keys' validity and the
    segment ids as int32 ``[B, S]`` (None without ids); raises on what the
    kernels do not take."""
    b, s, h, dh = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"training_attention: the CUDA kernels take bf16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in TRAIN_ATTENTION_HEAD_DIMS:
        raise ValueError(f"training_attention: the CUDA kernels take head_dim in "
                         f"{TRAIN_ATTENTION_HEAD_DIMS}, got {dh}")
    h_kv = k.shape[2]
    if k.shape != (b, s, h_kv, dh) or v.shape != k.shape or h % h_kv:
        raise ValueError(f"training_attention: q {tuple(q.shape)} against k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if attention_mask.shape != (b, s) or (segment_ids is not None and
                                          segment_ids.shape != (b, s)):
        raise ValueError(f"training_attention: the mask and segment ids must be [{b}, {s}]")
    valid = (attention_mask != 0).to(torch.int32).contiguous()
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    if any(t is not None and t.device != q.device for t in (k, v, valid, seg)):
        raise ValueError(f"training_attention: every operand must be on {q.device}")
    return _rows16(q), _rows16(k), _rows16(v), valid, seg


def train_attention_fwd(q, k, v, valid, seg, scale: float):
    """One launch of ``cgpt_train_attention_fwd``: ``(out, max, sum)``, the
    output [B, S, H, Dh] bf16 and each query row's max and sum of
    ``exp(l - max)`` [B, H, S] f32, from ``_train_attention_args``'
    operands."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    mx = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    sm = torch.empty_like(mx)
    code = cuda_kernels.build().lib.cgpt_train_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        None if seg is None else seg.data_ptr(), out.data_ptr(), mx.data_ptr(), sm.data_ptr(),
        b, s, h, k.shape[2], dh, scale, cuda_kernels.stream_of(q))
    train_attention_fwd.launches += 1
    cuda_kernels.check(code, "train_attention_fwd")
    return out, mx, sm


def _train_attention_bwd(part: int, q, k, v, valid, seg, g, mx, sm, dsum, dq, dk, dv, scale):
    b, s, h, dh = q.shape
    return cuda_kernels.build().lib.cgpt_train_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        None if seg is None else seg.data_ptr(), g.data_ptr(), mx.data_ptr(), sm.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], dh,
        scale, part, cuda_kernels.stream_of(q))


def train_attention_dq(q, k, v, valid, seg, g, mx, sm, scale: float):
    """One launch of the backward's first kernel: ``(dq, D)``, q's gradient
    and each row's ``D_i = sum_j P dP`` [B, H, S] f32."""
    dq = torch.empty_like(q)
    dsum = torch.empty_like(mx)
    code = _train_attention_bwd(0, q, k, v, valid, seg, g, mx, sm, dsum, dq, dq, dq, scale)
    train_attention_dq.launches += 1
    cuda_kernels.check(code, "train_attention_dq")
    return dq, dsum


def train_attention_dkv(q, k, v, valid, seg, g, mx, sm, dsum, scale: float):
    """One launch of the backward's second kernel: ``(dk, dv)``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _train_attention_bwd(1, q, k, v, valid, seg, g, mx, sm, dsum, dk, dk, dv, scale)
    train_attention_dkv.launches += 1
    cuda_kernels.check(code, "train_attention_dkv")
    return dk, dv


cuda_kernels.launch_counter(train_attention_fwd, r"\btrain_attention_fwd_kernel\b")
cuda_kernels.launch_counter(train_attention_dq, r"\btrain_attention_dq_kernel\b")
cuda_kernels.launch_counter(train_attention_dkv, r"\btrain_attention_dkv_kernel\b")


class _TrainingAttention(torch.autograd.Function):
    """``training_attention`` on the card. Forward: ``train_attention_fwd``.
    Backward: ``train_attention_dq`` (dq and each row's ``D``), then
    ``train_attention_dkv``. Saved: q, k, v, the mask's two int32 rows and
    the f32 row statistics [B, H, S]; no [S, S] tensor. Its output is no
    aten product, so under ``remat_policy: dots_all`` a recomputed block
    runs the forward kernel again, as it runs the W8A8 products."""

    @staticmethod
    def forward(ctx, q, k, v, valid, seg, scale):
        out, mx, sm = train_attention_fwd(q, k, v, valid, seg, scale)
        ctx.save_for_backward(q, k, v, valid, seg, mx, sm)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, seg, mx, sm = ctx.saved_tensors
        g = _rows16(g)
        dq, dsum = train_attention_dq(q, k, v, valid, seg, g, mx, sm, ctx.scale)
        dk, dv = train_attention_dkv(q, k, v, valid, seg, g, mx, sm, dsum, ctx.scale)
        return dq, dk, dv, None, None, None


def training_attention(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, H_kv, Dh]
    v: torch.Tensor,  # [B, S, H_kv, Dh]
    attention_mask: torch.Tensor,  # [B, S], nonzero = a valid key
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] packed-segment ids
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The decoder's self-attention without a cache (training and
    validation): ``multi_head_attention`` under ``training_mask``'s causal,
    key-validity and segment mask, differentiable. Returns [B, S, H, Dh] in
    q's dtype.

    Replaces the XLA fusion of the JAX package's ``multi_head_attention``
    (certifiedgpt_tpu/ops/attention.py:23-73) with the training mask
    (models/llama.py:323-331) and its autodiff. CPU tensors, and f32 q
    (whose reference products are f32), take ``_training_attention_plain``
    under autograd. bf16 q on the card runs ``csrc/train_attention.cu``
    (head_dim 128, Vicuna-7B's, or 16/32/64; other widths raise): the
    forward kernel (the weights normalized in f32 and rounded to bf16
    before ``P v``, as the reference rounds them) and two backward kernels,
    as ``_TrainingAttention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" or q.dtype == torch.float32:
        return _training_attention_plain(q, k, v, attention_mask, segment_ids, scale)
    args = _train_attention_args(q, k, v, attention_mask, segment_ids)
    return _TrainingAttention.apply(*args, float(scale))


#: the head_dim of the prefill's kv8 kernel (csrc/attention_kv8_prefill.cu kDh)
KV8_PREFILL_HEAD_DIM = 128
#: query heads a kv head that the decode kernel takes (its instances)
KV8_DECODE_GROUPS = (1, 2, 4, 8)
#: the kv8 launchers' code for a cache too long for their shared memory
#: (kCacheTooLong of csrc/attention_kv8_prefill.cu and csrc/attention_kv8_decode.cu)
_KV8_CACHE_TOO_LONG = -1


def kv8_kernel(dtype: torch.dtype, rows: int, head_dim: int, group: int, writes: bool) -> str:
    """Which int8-KV kernel a CUDA call launches, for q of ``dtype`` with
    ``rows`` query rows a batch row, ``head_dim``, ``group`` query heads a
    kv head, writing new rows into the cache or not: ``"prefill"``
    (csrc/attention_kv8_prefill.cu: bf16, several rows, head_dim 128, any
    group), ``"decode"`` (csrc/attention_kv8_decode.cu: one row, bf16 or
    f32, a group in ``KV8_DECODE_GROUPS``) or ``"tiled"``
    (csrc/attention_kv8.cu: the rest). Each takes new rows or none, so
    ``writes`` changes no choice; it is part of the question all the same."""
    del writes
    if dtype == torch.bfloat16 and rows > 1 and head_dim == KV8_PREFILL_HEAD_DIM:
        return "prefill"
    if rows == 1 and group in KV8_DECODE_GROUPS:
        return "decode"
    return "tiled"


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
    ``_multi_head_attention_kv8_plain``. CUDA tensors launch the kernel
    ``kv8_kernel`` names, with no rows to write; each reads the int8 cache
    and makes no dequantized copy: bf16 queries of several rows at head_dim
    128 ``cgpt_attention_kv8_prefill`` (counted in
    ``prefill_attention_kv8.launches``), a lone row at a group of
    ``KV8_DECODE_GROUPS`` ``cgpt_attention_kv8_decode`` (counted in
    ``decode_attention_kv8.launches``; the cache comes out bit for bit as it
    went in), anything else the tiled ``cgpt_attention_kv8`` (counted in
    ``multi_head_attention_kv8.launches``). The decoder's decode step takes
    ``decode_attention_kv8`` and its prefill ``prefill_attention_kv8``
    instead. The kernels take a head-agnostic mask (dimension 1 of size 1)
    and raise on a per-head one."""
    if q.device.type == "cpu":
        return _multi_head_attention_kv8_plain(q, kq8, ks, vq8, vs, mask, scale)
    b, sq, h, dh = q.shape
    t, h_kv = kq8.shape[1], kq8.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"multi_head_attention_kv8: the CUDA kernel takes bf16 or f32 q, got "
                        f"{q.dtype}")
    ks3, vs3 = _check_cache("multi_head_attention_kv8", b, h, dh, kq8, vq8, ks, vs)
    if scale is None:
        scale = dh ** -0.5
    kernel = kv8_kernel(q.dtype, sq, dh, h // h_kv, False)
    launch = {"prefill": _launch_prefill_kv8, "decode": _launch_decode_kv8,
              "tiled": _launch_tiled_kv8}[kernel]
    return launch(q, None, None, kq8, vq8, ks3, vs3, t, mask, scale)


cuda_kernels.launch_counter(multi_head_attention_kv8, r"\battention_kv8_kernel\b")
# the counter's owner, whatever a caller later binds to the module's name
_tiled_counter = multi_head_attention_kv8


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


def decode_attention_kv8(
    q: torch.Tensor,  # [B, 1, H, Dh] the step's rotated queries
    k: torch.Tensor,  # [B, 1, H_kv, Dh] the step's rotated keys
    v: torch.Tensor,  # [B, 1, H_kv, Dh] the step's values
    cache: dict,  # "k", "v" int8 [B, T, H_kv, Dh]; "k_scale", "v_scale" f32 [B, T, H_kv, 1]
    offset,  # the cache slot of the step: an int, or a 0-dim int32 tensor on q's device
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, 1, 1, T]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step over the int8 KV cache: quantizes the step's k and v
    rows into slot ``offset`` of the cache (in place; codes and scales bit
    for bit ``quantize_rows``'), then attends over the whole cache as
    ``multi_head_attention_kv8`` does. Returns [B, 1, H, Dh] in q's dtype.

    ``offset`` may be a 0-dim int32 tensor on q's device (the slot of a
    decode loop that advances it on the device, so that one CUDA graph
    serves every step): the kernel reads it when it runs, and traps on a
    slot outside ``[0, T)``; an int slot is checked here.

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
    if isinstance(offset, torch.Tensor):
        if offset.dim() != 0 or offset.dtype != torch.int32 or offset.device != q.device:
            raise TypeError(f"decode_attention_kv8: a tensor offset must be a 0-dim int32 "
                            f"tensor on {q.device}, got {offset.dtype} {tuple(offset.shape)} "
                            f"on {offset.device}")
    elif not 0 <= offset < t:
        raise ValueError(f"decode_attention_kv8: offset {offset} outside a cache of {t} slots")
    if q.device.type == "cpu":
        return _decode_attention_kv8_plain(q, k, v, cache, offset, mask, scale)
    b, _, h, dh = q.shape
    kc, vc = cache["k"], cache["v"]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention_kv8: the CUDA kernel takes bf16 or f32 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    ks3, vs3 = _check_cache("decode_attention_kv8", b, h, dh, kc, vc, cache["k_scale"],
                            cache["v_scale"])
    if k.shape != (b, 1, kc.shape[2], dh) or h // kc.shape[2] not in KV8_DECODE_GROUPS:
        raise ValueError(f"decode_attention_kv8: q {tuple(q.shape)}, k {tuple(k.shape)} against "
                         f"a cache {tuple(kc.shape)}: the kernel takes {KV8_DECODE_GROUPS} "
                         "query heads a kv head")
    if scale is None:
        scale = dh ** -0.5
    return _launch_decode_kv8(q, k, v, kc, vc, ks3, vs3, offset, mask, scale)


cuda_kernels.launch_counter(decode_attention_kv8, r"\bkv8_decode_kernel\b")
# the counter's owner, whatever a caller later binds to the module's name
_decode_counter = decode_attention_kv8


def write_slots(buf: torch.Tensor, offset, rows: torch.Tensor) -> None:
    """``buf[:, offset:offset + S] = rows`` for ``rows`` [B, S, ...]; an
    ``offset`` given as a 0-dim tensor on ``buf``'s device is read there
    (``index_copy_`` at ``offset + arange(S)``), with no host read."""
    if isinstance(offset, torch.Tensor):
        at = offset.long() + torch.arange(rows.shape[1], device=buf.device)
        buf.index_copy_(1, at, rows.to(buf.dtype))
    else:
        buf[:, offset:offset + rows.shape[1]] = rows


def _aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are contiguous, 16-byte aligned and 16-byte
    strided in elements of 2 or 4 bytes (a kernel copies them 16 bytes at a
    time), else a contiguous copy."""
    if x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch_decode_kv8(q, k, v, kc, vc, ks3, vs3, offset, mask, scale):
    """One launch of ``cgpt_attention_kv8_decode`` for one query row a batch
    row: with the step's rows ``k``, ``v`` it writes them at ``offset``, an
    int or a 0-dim int32 tensor that the kernel reads on the device (``k``
    None: it writes nothing and ``offset`` is the cache length), then
    attends over the whole cache. The caller has checked the cache."""
    b, _, h, dh = q.shape
    t, h_kv = kc.shape[1], kc.shape[2]
    q = _aligned_rows(q)
    new = (None, None, 0, 0)
    if k is not None:
        k, v = _aligned_rows(k), _aligned_rows(v)
        if v.stride() != k.stride():
            k, v = k.contiguous(), v.contiguous()
        new = (k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(2))
    mask_ptr, mask_strides = None, (0, 0)
    if mask is not None:
        if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(f"decode_attention_kv8: the CUDA kernel takes a head-agnostic "
                             f"mask [B|1, 1, 1, T], got {tuple(mask.shape)}")
        m2 = mask.to(torch.bool).expand(b, 1, 1, t)[:, 0, 0]
        mask_ptr, mask_strides = m2.data_ptr(), m2.stride()
    slot = None
    if isinstance(offset, torch.Tensor):
        slot, offset = offset.data_ptr(), 0
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8_decode(
        q.data_ptr(), q.stride(0), q.stride(2), *new,
        kc.data_ptr(), vc.data_ptr(), *kc.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, h, h_kv, t, dh, offset, slot, float(scale), int(q.dtype == torch.float32),
        cuda_kernels.stream_of(q))
    if code == _KV8_CACHE_TOO_LONG:
        raise ValueError(f"decode_attention_kv8: a cache of {t} positions does not fit the "
                         "kernel's shared memory")
    _decode_counter.launches += 1
    cuda_kernels.check(code, "decode_attention_kv8")
    return out


def _decode_attention_kv8_plain(q, k, v, cache, offset, mask=None, scale=None):
    """``decode_attention_kv8`` in plain PyTorch: the decoder block's
    sequence before the kernel, as the JAX package runs it: the step's k
    and v rows quantized, written to slot ``offset`` (an int, or a 0-dim
    tensor: ``index_copy_`` at that index) of the four cache tensors, then
    ``_multi_head_attention_kv8_plain`` over the cache."""
    kq, ks = Q._quantize_rows_plain(k)
    vq, vs = Q._quantize_rows_plain(v)
    for name, rows in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
        write_slots(cache[name], offset, rows)
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
    sequence). CUDA tensors launch the kernel ``kv8_kernel`` names, one
    launch that writes the cache and attends, at any cache length: bf16 q,
    k and v of more than one row at head_dim 128
    ``cgpt_attention_kv8_prefill`` (csrc/attention_kv8_prefill.cu, any
    ``H / H_kv``), one row at a group of ``KV8_DECODE_GROUPS`` the decode
    kernel, anything else (f32, which serves the tiny and f32
    configurations; another head width) the tiled ``cgpt_attention_kv8``
    (csrc/attention_kv8.cu). The kernels take a head-agnostic mask and
    raise otherwise; a build or launch failure raises."""
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
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"prefill_attention_kv8: the CUDA kernels take bf16 or f32 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kc, vc = cache["k"], cache["v"]
    if k.shape != (b, s, kc.shape[2], dh):
        raise ValueError(f"prefill_attention_kv8: k {tuple(k.shape)} against a cache "
                         f"{tuple(kc.shape)}")
    ks3, vs3 = _check_cache("prefill_attention_kv8", b, h, dh, kc, vc, cache["k_scale"],
                            cache["v_scale"])
    if scale is None:
        scale = dh ** -0.5
    kernel = kv8_kernel(q.dtype, s, dh, h // kc.shape[2], True)
    if kernel == "prefill":
        # the kernel's tensor copies read the new rows 16 bytes at a time
        k, v = _aligned_rows(k), _aligned_rows(v)
    launch = {"prefill": _launch_prefill_kv8, "decode": _launch_decode_kv8,
              "tiled": _launch_tiled_kv8}[kernel]
    return launch(q, k, v, kc, vc, ks3, vs3, offset, mask, scale)


cuda_kernels.launch_counter(prefill_attention_kv8, r"\bkv8_prefill_kernel\b")
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


def _launch_tiled_kv8(q, k, v, kc, vc, ks3, vs3, offset, mask, scale):
    """One launch of the tiled ``cgpt_attention_kv8``: with new rows ``k``,
    ``v`` it writes them at ``offset`` (``k`` None: it writes nothing), then
    attends over the whole cache. The caller has checked the cache."""
    b, sq, h, dh = q.shape
    t, h_kv = kc.shape[1], kc.shape[2]
    q = _aligned_rows(q)  # the kernel reads q, k and v four values at a time
    mask_ptr, mask_strides = _mask_bytes("multi_head_attention_kv8", mask, b, sq, t)
    sn, new = 0, (None, 0, 0, 0, None, 0, 0, 0)
    if k is not None:
        k, v = _aligned_rows(k), _aligned_rows(v)
        sn = k.shape[1]
        new = (k.data_ptr(), *k.stride()[:3], v.data_ptr(), *v.stride()[:3])
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    code = cuda_kernels.build().lib.cgpt_attention_kv8(
        q.data_ptr(), *q.stride()[:3], *new,
        kc.data_ptr(), vc.data_ptr(), *kc.stride()[:3],
        ks3.data_ptr(), vs3.data_ptr(), *ks3.stride(),
        mask_ptr, *mask_strides, out.data_ptr(),
        b, sq, h, h_kv, t, dh, offset, sn, float(scale), int(q.dtype == torch.float32),
        cuda_kernels.stream_of(q))
    _tiled_counter.launches += 1
    cuda_kernels.check(code, "multi_head_attention_kv8")
    return out


def tiled_kv8_plan(sq: int, group: int, head_dim: int, f32: bool) -> dict:
    """The tiled kernel's launch plan (a host computation): warps a block,
    row tiles a (batch row, kv head) item, shared bytes a block."""
    import ctypes

    out = (ctypes.c_int * 3)()
    code = cuda_kernels.build().lib.cgpt_attention_kv8_plan(sq, group, head_dim, int(f32), out)
    cuda_kernels.check(code, "tiled_kv8_plan")
    return dict(zip(("warps", "row_tiles", "smem_bytes"), out))


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
