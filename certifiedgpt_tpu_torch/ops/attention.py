"""Attention compute ops (plain PyTorch).

Port of ``certifiedgpt_tpu/ops/attention.py``. ``multi_head_attention`` serves
the Q-Former, the decoder and the ViT's plain path; ``multi_head_attention_kv8``
is the same numerics over an int8 KV cache. Both share the masked-softmax core.
As in the JAX package, products take bf16 (or f32) operands with f32
accumulation: the operands are upcast to f32 here, which gives the same
values as JAX's ``preferred_element_type=float32`` (bf16 products are exact
in f32). Shapes follow [batch, seq, heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch

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


def multi_head_attention_kv8(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    kq8: torch.Tensor,  # [B, Sk, H_kv, Dh] int8
    ks: torch.Tensor,  # [B, Sk, H_kv, 1] f32 per-row scales
    vq8: torch.Tensor,  # [B, Sk, H_kv, Dh] int8
    vs: torch.Tensor,  # [B, Sk, H_kv, 1] f32
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over an int8 KV cache with the per-row scales applied to
    the score and weight tensors (``dequant(kq8) = kq8 * ks`` commutes with
    both contractions). Grouped-query caches are contracted as
    [B, Sq, H_kv, G, Dh] against the H_kv cache directly."""
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
