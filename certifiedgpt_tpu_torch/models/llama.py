"""LLaMA/Vicuna decoder, cached (serving) mode.

Port of ``certifiedgpt_tpu/models/llama.py`` for generation: rotary,
RMSNorm and SwiGLU as in HF LLaMA, a per-layer KV cache (optionally int8
with per-(batch, position, head) f32 scales), W8A8 on multi-token calls
only (``act_quant``: prefill; single-token decode keeps the weight-only
path). The training forward (no cache, packing, remat) waits for a later
slice.

Unlike the JAX package, whose arrays are immutable, the cache buffers are
updated in place: ``llama_apply`` writes the new keys/values into the
tensors it is given and returns the same dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.ops.attention import (
    multi_head_attention,
    multi_head_attention_kv8,
)
from certifiedgpt_tpu_torch.ops.quantization import quantize_rows


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # W8A8 on multi-token (prefill) calls when the layer kernels are int8
    act_quant: bool = False
    # int8 KV cache with per-row f32 scale sidecars
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=4, max_position_embeddings=128,
            dtype=torch.float32,
        )
        base.update(overrides)
        return LlamaConfig(**base)


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed_tokens"], ids)


def lm_head_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states [..., D] -> f32 vocabulary logits (+ the optional bias)."""
    logits = torch.matmul(hidden.float(), params["lm_head"]["kernel"].float())
    bias = params["lm_head"].get("bias")
    if bias is not None:
        logits = logits + bias.float()
    return logits


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device="cuda") -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Per-layer cache buffers ``[B, T, Hkv, Dh]``; with ``kv_quant`` int8
    plus ``k_scale``/``v_scale`` ``[B, T, Hkv, 1]`` f32."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = torch.int8 if cfg.kv_quant else cfg.dtype

    def bufs(shp, dt):
        return tuple(torch.zeros(shp, dtype=dt, device=device) for _ in range(cfg.num_layers))

    cache = {"k": bufs(shape, dtype), "v": bufs(shape, dtype)}
    if cfg.kv_quant:
        cache["k_scale"] = bufs(shape[:-1] + (1,), torch.float32)
        cache["v_scale"] = bufs(shape[:-1] + (1,), torch.float32)
    return cache


def _block(x, lp, cfg: LlamaConfig, cos, sin, positions, mask, cache, cache_offset):
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    aq = cfg.act_quant and s > 1  # prefill only; decode is bandwidth-bound

    hidden = L.rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    q = L.dense(lp["q_proj"], hidden, act_quant=aq).reshape(b, s, h, dh)
    k = L.dense(lp["k_proj"], hidden, act_quant=aq).reshape(b, s, hkv, dh)
    v = L.dense(lp["v_proj"], hidden, act_quant=aq).reshape(b, s, hkv, dh)
    q = L.apply_rotary(q, cos, sin, positions)
    k = L.apply_rotary(k, cos, sin, positions)

    at = slice(cache_offset, cache_offset + s)
    if cfg.kv_quant:
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        cache["k"][:, at] = kq
        cache["v"][:, at] = vq
        cache["k_scale"][:, at] = ks
        cache["v_scale"][:, at] = vs
        attn = multi_head_attention_kv8(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], mask
        )
    else:
        cache["k"][:, at] = k
        cache["v"][:, at] = v
        attn = multi_head_attention(q, cache["k"], cache["v"], mask)

    x = x + L.dense(lp["o_proj"], attn.reshape(b, s, h * dh), act_quant=aq)
    hidden = L.rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    gate = L.silu(L.dense(lp["gate_proj"], hidden, act_quant=aq))
    up = L.dense(lp["up_proj"], hidden, act_quant=aq)
    return x + L.dense(lp["down_proj"], gate * up, act_quant=aq)


def llama_apply(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D]
    attention_mask: torch.Tensor,  # [B, max_len] 1 = valid cache slot
    positions: torch.Tensor,  # [B, S] rotary positions of the query tokens
    kv_cache: Dict[str, Tuple[torch.Tensor, ...]],
    cache_offset: int,
    compute_logits: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, Dict[str, Tuple[torch.Tensor, ...]]]:
    """Cached forward: the S query tokens write their keys/values at
    ``cache_offset`` and attend over the whole cache; query i (position
    ``cache_offset + i``) sees slot j iff ``j <= cache_offset + i`` and the
    slot is valid. Returns ``(logits or None, final hidden, cache)``."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    cos, sin = L.rotary_tables(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, device=device)
    sk = kv_cache["k"][0].shape[1]
    q_pos = cache_offset + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = (k_pos <= q_pos)[None, None] & attention_mask[:, None, None, :].bool()

    x = inputs_embeds.to(cfg.dtype)
    names = tuple(kv_cache)
    for layer in range(cfg.num_layers):
        lp = L.layer_slice(params["layers"], layer)
        layer_cache = {name: kv_cache[name][layer] for name in names}
        x = _block(x, lp, cfg, cos, sin, positions, mask, layer_cache, cache_offset)
    x = L.rms_norm(params["norm"], x, cfg.rms_norm_eps)
    logits = lm_head_logits(params, x) if compute_logits else None
    return logits, x, kv_cache


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = L.ParamTree(params)

    def forward(self, inputs_embeds, attention_mask, positions, kv_cache,
                cache_offset, compute_logits=True):
        return llama_apply(self.params.tree(), self.cfg, inputs_embeds, attention_mask,
                           positions, kv_cache, cache_offset, compute_logits)
