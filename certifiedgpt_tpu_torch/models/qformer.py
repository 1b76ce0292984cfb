"""Q-Former (BLIP-2 querying transformer).

Port of ``certifiedgpt_tpu/models/qformer.py``. ``qformer_apply`` is the
query mode MiniGPT-4 runs: the learned query tokens pass the embeddings
LayerNorm, then post-LN BERT blocks with self-attention, cross-attention
into the image tokens on layers where ``layer % cross_attention_freq == 0``,
and the query feed-forward branch. The text-conditioned surface of BLIP-2's
BERT (``qformer_text_apply``, ``qformer_lm_logits``) reads the leaves that a
BLIP-2 checkpoint carries beside the query path's (the word and position
embeddings, each layer's text feed-forward branch, the LM head); the query
path ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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
    # the text surface: BERT's vocabulary and absolute positions
    vocab_size: int = 30522
    max_position_embeddings: int = 512

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
            dtype=torch.float32, vocab_size=64, max_position_embeddings=32,
        )
        base.update(overrides)
        return QFormerConfig(**base)


def _attend(q_params, k_params, v_params, out_params, ln_params, x, kv, cfg, mask=None):
    """One post-LN attention sub-block: attn -> dense -> LN(res + x)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = L.dense(q_params, x).reshape(b, s, h, dh)
    k = L.dense(k_params, kv).reshape(b, kv.shape[1], h, dh)
    v = L.dense(v_params, kv).reshape(b, kv.shape[1], h, dh)
    attn = multi_head_attention(q, k, v, mask).reshape(b, s, h * dh)
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


def init_qformer_text(cfg: QFormerConfig, device="cpu", seed: int = 0) -> Dict[str, Any]:
    """Seeded parameters of the query path plus the text surface: the word
    and position embeddings, each layer's text feed-forward branch and the
    LM head (its decoder tied to the word embeddings)."""
    from certifiedgpt_tpu_torch.models.model_zoo import _Init, _qformer_params

    init = _Init(seed, device)
    params = _qformer_params(init, cfg)
    d, dt = cfg.hidden_size, cfg.dtype
    params["word_embeddings"] = {"embedding": init.normal((cfg.vocab_size, d), 0.02, dt)}
    params["position_embeddings"] = {
        "embedding": init.normal((cfg.max_position_embeddings, d), 0.02, dt)}
    for i in range(cfg.num_layers):
        lp = params["layers"][f"layer_{i}"]
        lp["int_txt"] = init.dense(d, cfg.intermediate_size, dt)
        lp["out_txt"] = init.dense(cfg.intermediate_size, d, dt)
        lp["ffn_ln_txt"] = {"scale": init.const((d,), 1.0, dt), "bias": init.const((d,), 0.0, dt)}
    params["cls_transform"] = init.dense(d, d, dt)
    params["cls_ln"] = {"scale": init.const((d,), 1.0, dt), "bias": init.const((d,), 0.0, dt)}
    params["cls_bias"] = init.const((cfg.vocab_size,), 0.0, dt)
    return params


def qformer_text_apply(params: Dict[str, Any], cfg: QFormerConfig,
                       input_ids: torch.Tensor,  # [B, T]
                       attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = valid
                       image_embeds: Optional[torch.Tensor] = None,  # [B, S_img, encoder_width]
                       with_query: bool = True, causal: bool = False) -> torch.Tensor:
    """Text-conditioned forward. ``with_query`` prepends the learned query
    tokens (queries cross-attend into ``image_embeds`` on cross layers, text
    does not). ``causal=False`` is bidirectional; ``causal=True`` the
    UniLM mask: queries see only queries, text sees every query and its own
    causal prefix. Returns [B, (Q +) T, hidden]."""
    b, t = input_ids.shape
    device = input_ids.device
    text = L.embed(params["word_embeddings"], input_ids)
    text = text + L.embed(params["position_embeddings"],
                          torch.arange(t, device=device).expand(b, t))
    nq = cfg.num_query_tokens if with_query else 0
    if with_query:
        query = params["query_tokens"].to(text.dtype).expand(b, nq, cfg.hidden_size)
        x = torch.cat([query, text], dim=1)
    else:
        x = text
    x = L.layer_norm(params["embeddings_ln"], x, cfg.layer_norm_eps)

    s = nq + t
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=device)
    key_valid = torch.cat([torch.ones((b, nq), dtype=torch.bool, device=device),
                           attention_mask.bool()], dim=1)
    mask = key_valid[:, None, None, :]  # [B, 1, 1, S]
    if causal:
        pos = torch.arange(s, device=device)
        is_text_k = pos >= nq
        allowed = torch.where((pos < nq)[:, None], ~is_text_k[None, :],
                              ~is_text_k[None, :] | (pos[None, :] <= pos[:, None]))
        mask = mask & allowed[None, None]

    kv_img = None if image_embeds is None else image_embeds.to(x.dtype)
    for i in range(cfg.num_layers):
        lp = params["layers"][f"layer_{i}"]
        x = _attend(lp["self_q"], lp["self_k"], lp["self_v"], lp["self_out"],
                    lp["self_ln"], x, x, cfg, mask=mask)
        if with_query:
            xq, xt = x[:, :nq], x[:, nq:]
            if cfg.has_cross_attention(i) and kv_img is not None:
                xq = _attend(lp["cross_q"], lp["cross_k"], lp["cross_v"], lp["cross_out"],
                             lp["cross_ln"], xq, kv_img, cfg)
            hq = L.dense(lp["out_q"], L.gelu(L.dense(lp["int_q"], xq)))
            xq = L.layer_norm(lp["ffn_ln_q"], hq + xq, cfg.layer_norm_eps)
            ht = L.dense(lp["out_txt"], L.gelu(L.dense(lp["int_txt"], xt)))
            xt = L.layer_norm(lp["ffn_ln_txt"], ht + xt, cfg.layer_norm_eps)
            x = torch.cat([xq, xt], dim=1)
        else:
            ht = L.dense(lp["out_txt"], L.gelu(L.dense(lp["int_txt"], x)))
            x = L.layer_norm(lp["ffn_ln_txt"], ht + x, cfg.layer_norm_eps)
    return x


def qformer_lm_logits(params: Dict[str, Any], cfg: QFormerConfig,
                      hidden: torch.Tensor) -> torch.Tensor:
    """The causal-LM head: transform -> GELU -> LN -> the word embeddings'
    transpose (f32 accumulation) + bias; f32 logits."""
    h = L.gelu(L.dense(params["cls_transform"], hidden))
    h = L.layer_norm(params["cls_ln"], h, cfg.layer_norm_eps)
    logits = torch.matmul(h.float(), params["word_embeddings"]["embedding"].float().T)
    return logits + params["cls_bias"].float()


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = L.ParamTree(params)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        return qformer_apply(self.params.tree(), self.cfg, image_embeds)
