"""EVA ViT-g/14 vision encoder.

Port of ``certifiedgpt_tpu/models/eva_vit.py``: patch embedding as an
unfold + matmul in torch-conv (C, ph, pw) order, BEiT attention (fused
biasless qkv kernel, q/v bias vectors, zero k bias), pre-norm blocks,
exact-GELU MLP, no final norm. Returns the [cls] + patch token sequence.

The attention forms of the JAX package (``EvaViTConfig.attn_impl``):
- ``"flash_cls"`` with a patch count divisible by 128 (the serving path):
  the split-stream tower, cls and patch residual streams kept apart across
  all layers, attention through the cls-split CUDA kernel
  (``ops/flash_attention.py``), and on the W8A8 path the LN + row-quant
  CUDA kernel (``ops/quantization.py``) at the qkv and fc1 inputs;
- ``"flash"``, and ``"flash_cls"`` with any other patch count: the block
  over the concatenated sequence, q, k, v as ``[B, H, S, dh]`` views of one
  fused qkv product, attention through the flash CUDA kernel
  (``builtin_flash_attention_bhsd``);
- ``"flash_custom"``: the same block with the qkv product split into
  ``[B, S, H, dh]`` views, attention through the flash CUDA kernel
  (``flash_attention``);
- ``"xla"``: the same block with plain attention.
Every block form runs its fc2 input through the GELU + row-quant CUDA kernel
on the W8A8 path. Any other string raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn as nn

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.ops import quantization as Q
from certifiedgpt_tpu_torch.ops.attention import multi_head_attention
from certifiedgpt_tpu_torch.ops.flash_attention import (
    CLS_SPLIT_Q_PREMUL_LOG2E,
    builtin_flash_attention_bhsd,
    cls_split_attention_parts,
    flash_attention,
)


@dataclasses.dataclass(frozen=True)
class EvaViTConfig:
    img_size: int = 448
    patch_size: int = 14
    in_channels: int = 3
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden: int = 6144  # round(1408 * 4.3637)
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # "xla" (plain attention), "flash" / "flash_custom" (the flash kernel on
    # [B, H, S, dh] / [B, S, H, dh] views) or "flash_cls" (the cls-split
    # serving path; "flash" when the patch count is not a multiple of 128)
    attn_impl: str = "xla"
    # W8A8: with int8 qkv/proj/fc1/fc2 kernels, also quantize activations
    act_quant: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @staticmethod
    def eva_vit_g() -> "EvaViTConfig":
        return EvaViTConfig()

    @staticmethod
    def tiny(**overrides) -> "EvaViTConfig":
        base = dict(
            img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
            mlp_hidden=64, dtype=torch.float32,
        )
        base.update(overrides)
        return EvaViTConfig(**base)


def patchify(images: torch.Tensor, cfg: EvaViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, C*P*P] in torch-conv (C, ph, pw)
    order, matching a Conv2d weight [D, C, P, P]."""
    b, _, _, c = images.shape
    p, g = cfg.patch_size, cfg.grid
    x = images.reshape(b, g, p, g, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, g * g, c * p * p)


def _qkv_heads(lp: Dict[str, Any], hidden: torch.Tensor, cfg: EvaViTConfig,
               q_premul: float = 1.0, ln: Dict[str, Any] = None):
    """q, k, v as ``[B, H, S, dh]`` views of one fused qkv product
    ``[B, S, 3, H, dh]`` (port of the JAX ``_qkv_headpadded``).

    The JAX package pads dh to 128 lanes in this product; here nothing is
    padded in device memory: the attention kernels read the strided views
    and pad inside shared memory. ``q_premul`` folds a factor into the q
    weights (float kernels) or into the f32 dequant scale (int8 kernels),
    and into the q bias. ``ln`` is the pre-attention LayerNorm, fused with
    the activation quant on the W8A8 path."""
    b, s, _ = hidden.shape
    h, dh, d = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    p = lp["qkv"]
    # the k bias is identically zero
    qb = lp["q_bias"].to(hidden.dtype)
    if q_premul != 1.0:
        qb = qb * torch.tensor(q_premul, dtype=qb.dtype)
    bias = torch.cat([qb, torch.zeros_like(qb), lp["v_bias"].to(hidden.dtype)])
    if "kernel_q" in p:
        # int8 kernels: the factor goes into the f32 dequant scale of q
        scale = torch.cat([p["scale"][:d] * q_premul, p["scale"][d:]])
    if "kernel_q" in p and cfg.act_quant:
        if ln is not None:
            xq, xs = Q.ln_quant_rows(hidden, ln["scale"], ln["bias"], cfg.layer_norm_eps)
        else:
            xq, xs = Q.quantize_rows(hidden)
        # the bias is added in the product's epilogue (w8a8_product)
        y = Q._w8a8_epilogue(xq, xs, p["kernel_q"], scale, hidden.dtype, bias)
    else:
        if ln is not None:
            hidden = L.layer_norm(ln, hidden, cfg.layer_norm_eps)
        if "kernel_q" in p:
            y = L.dense({"kernel_q": p["kernel_q"], "scale": scale}, hidden)
        else:
            w = p["kernel"].reshape(-1, 3, d)
            if q_premul != 1.0:
                w = torch.cat([w[:, :1] * torch.tensor(q_premul, dtype=w.dtype), w[:, 1:]], dim=1)
            y = L.dense({"kernel": w.reshape(-1, 3 * d)}, hidden)
        y = y + bias
    y = y.reshape(b, s, 3, h, dh)
    return tuple(y[:, :, i].transpose(1, 2) for i in range(3))


def _vit_block(x: torch.Tensor, lp: Dict[str, Any], cfg: EvaViTConfig) -> torch.Tensor:
    b, s, d = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    aq = cfg.act_quant
    hidden = L.layer_norm(lp["norm1"], x, cfg.layer_norm_eps)
    if cfg.attn_impl in ("flash", "flash_cls"):
        # "flash_cls" lands here only when the patch count is not a multiple
        # of 128; the eligible case takes the split-stream tower
        qp, kp, vp = _qkv_heads(lp, hidden, cfg)
        attn = builtin_flash_attention_bhsd(qp, kp, vp, dh).transpose(1, 2)  # [B, S, H, dh]
    else:
        qkv = L.dense(lp["qkv"], hidden, act_quant=aq)  # biasless [B, S, 3D]
        q, k, v = qkv.split(d, dim=-1)
        q = (q + lp["q_bias"].to(q.dtype)).reshape(b, s, h, dh)
        k = k.reshape(b, s, h, dh)  # k bias is identically zero
        v = (v + lp["v_bias"].to(v.dtype)).reshape(b, s, h, dh)
        if cfg.attn_impl == "flash_custom":
            attn = flash_attention(q, k, v)
        elif cfg.attn_impl == "xla":
            attn = multi_head_attention(q, k, v)
        else:
            # a typo ("Flash", "flash-custom") must not fall back to another
            # path silently
            raise ValueError(
                f"unknown attn_impl {cfg.attn_impl!r}: "
                "use 'xla', 'flash', 'flash_cls' or 'flash_custom'"
            )
    x = x + L.dense(lp["proj"], attn.reshape(b, s, d), act_quant=aq)
    hidden = L.layer_norm(lp["norm2"], x, cfg.layer_norm_eps)
    hidden = L.gelu_dense(lp["fc2"], L.dense(lp["fc1"], hidden, act_quant=aq), act_quant=aq)
    return x + hidden


def _vit_block_split(xc: torch.Tensor, xp: torch.Tensor, lp: Dict[str, Any],
                     cfg: EvaViTConfig):
    """One layer on the split residual stream: ``xc [B, 1, D]`` (cls) and
    ``xp [B, N, D]`` (patches). LN, MLP and residuals are per token; the
    attention joins the parts in the cls-split kernel, with
    ``dh**-0.5 * log2(e)`` folded into the q weights."""
    b = xp.shape[0]
    d, dh = cfg.embed_dim, cfg.head_dim
    aq = cfg.act_quant
    prem = (dh ** -0.5) * CLS_SPLIT_Q_PREMUL_LOG2E
    qp, kp, vp = _qkv_heads(lp, xp, cfg, q_premul=prem, ln=lp["norm1"])
    qc, kc, vc = _qkv_heads(lp, xc, cfg, q_premul=prem, ln=lp["norm1"])
    out_c, out_p = cls_split_attention_parts(qp, kp, vp, qc, kc, vc)
    attn_p = out_p.transpose(1, 2).reshape(b, -1, d)
    attn_c = out_c.transpose(1, 2).reshape(b, 1, d)
    xp = xp + L.dense(lp["proj"], attn_p, act_quant=aq)
    xc = xc + L.dense(lp["proj"], attn_c, act_quant=aq)
    eps = cfg.layer_norm_eps
    xp = xp + L.gelu_dense(lp["fc2"], L.ln_dense(lp["fc1"], xp, lp["norm2"], eps, aq), aq)
    xc = xc + L.gelu_dense(lp["fc2"], L.ln_dense(lp["fc1"], xc, lp["norm2"], eps, aq), aq)
    return xc, xp


def eva_vit_apply(params: Dict[str, Any], cfg: EvaViTConfig,
                  images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] (normalized) -> tokens [B, 1 + N, D]."""
    x = patchify(images.to(cfg.dtype), cfg)
    x = L.dense(params["patch_embed"], x)
    b = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.embed_dim)
    pos = params["pos_embed"].to(x.dtype)
    depth = params["layers"]["norm1"]["scale"].shape[0]

    if cfg.attn_impl == "flash_cls" and cfg.num_patches % 128 == 0:
        xc = cls + pos[:, :1]
        xp = x + pos[:, 1:]
        for layer in range(depth):
            xc, xp = _vit_block_split(xc, xp, L.layer_slice(params["layers"], layer), cfg)
        return torch.cat([xc, xp], dim=1)
    x = torch.cat([cls, x], dim=1) + pos
    for layer in range(depth):
        x = _vit_block(x, L.layer_slice(params["layers"], layer), cfg)
    return x


class EvaViT(nn.Module):
    """The tower as a module: parameters in the JAX layout, forward through
    ``eva_vit_apply``."""

    def __init__(self, cfg: EvaViTConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = L.ParamTree(params)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return eva_vit_apply(self.params.tree(), self.cfg, images)
