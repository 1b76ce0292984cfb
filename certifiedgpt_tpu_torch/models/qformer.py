"""Q-Former (BLIP-2 querying transformer), query mode.

Port of ``qformer_apply`` of ``certifiedgpt_tpu/models/qformer.py``: the
learned query tokens pass the embeddings LayerNorm, then post-LN BERT
blocks with self-attention, cross-attention into the image tokens on layers
where ``layer % cross_attention_freq == 0``, and the query feed-forward
branch. The text-conditioned surface waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn as nn

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_freq: int = 2
    encoder_width: int = 1408  # ViT embed dim
    num_query_tokens: int = 32
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def has_cross_attention(self, layer: int) -> bool:
        return layer % self.cross_attention_freq == 0

    @staticmethod
    def blip2() -> "QFormerConfig":
        return QFormerConfig()

    @staticmethod
    def tiny(**overrides) -> "QFormerConfig":
        base = dict(
            hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
            cross_attention_freq=2, encoder_width=48, num_query_tokens=8,
            dtype=torch.float32,
        )
        base.update(overrides)
        return QFormerConfig(**base)


def _attend(q_params, k_params, v_params, out_params, ln_params, x, kv, cfg):
    """One post-LN attention sub-block: attn -> dense -> LN(res + x)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = L.dense(q_params, x).reshape(b, s, h, dh)
    k = L.dense(k_params, kv).reshape(b, kv.shape[1], h, dh)
    v = L.dense(v_params, kv).reshape(b, kv.shape[1], h, dh)
    attn = multi_head_attention(q, k, v).reshape(b, s, h * dh)
    return L.layer_norm(ln_params, L.dense(out_params, attn) + x, cfg.layer_norm_eps)


def qformer_apply(params: Dict[str, Any], cfg: QFormerConfig,
                  image_embeds: torch.Tensor) -> torch.Tensor:
    """[B, S_img, encoder_width] image tokens -> [B, num_query_tokens, hidden]."""
    b = image_embeds.shape[0]
    x = params["query_tokens"].to(cfg.dtype).expand(b, cfg.num_query_tokens, cfg.hidden_size)
    x = L.layer_norm(params["embeddings_ln"], x, cfg.layer_norm_eps)
    kv_img = image_embeds.to(cfg.dtype)
    for i in range(cfg.num_layers):
        lp = params["layers"][f"layer_{i}"]
        x = _attend(lp["self_q"], lp["self_k"], lp["self_v"], lp["self_out"],
                    lp["self_ln"], x, x, cfg)
        if cfg.has_cross_attention(i):
            x = _attend(lp["cross_q"], lp["cross_k"], lp["cross_v"], lp["cross_out"],
                        lp["cross_ln"], x, kv_img, cfg)
        hidden = L.dense(lp["out_q"], L.gelu(L.dense(lp["int_q"], x)))
        x = L.layer_norm(lp["ffn_ln_q"], hidden + x, cfg.layer_norm_eps)
    return x


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = L.ParamTree(params)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        return qformer_apply(self.params.tree(), self.cfg, image_embeds)
