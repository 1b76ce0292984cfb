"""CLIP encoders (image ViT, modified ResNet, causal text tower).

Port of ``certifiedgpt_tpu/attack/clip.py``: the surrogate ensemble of the
attack stage.

- ``clip_vit_image``: pre-LN ViT with a class embedding, QuickGELU MLPs,
  ``ln_post`` and a projection (the OpenAI/HF CLIP vision tower).
- ``clip_text``: causal transformer pooled at the EOT token (the highest id
  of each row) and projected.
- ``clip_resnet_image``: the modified ResNet of RN50/RN101 (3-conv stem and
  avgpool, bottlenecks with an avgpool before ``conv3`` and in the
  downsample, attention-pool head).

Parameters keep the JAX package's tree, so a JAX tree carries across with
a plain conversion (``models/from_jax.py::surrogate_params_from_jax``):
``[in, out]`` dense kernels, HWIO conv kernels (permuted to OIHW at the
call), BatchNorm as ``scale/bias/mean/var`` running statistics (never a
training-mode batch norm), ``layers`` as a list of block dicts. Convolutions
pad ``(k - 1) // 2`` on each side, as the JAX package's explicit padding.
Seeded inits draw from a ``torch.Generator`` on the target device (their
values differ from the JAX package's ``jax.random`` draws).

Converters read an HF ``CLIPModel`` state dict (ViT and text) and the OpenAI
``visual.*`` layout of the ResNets; each source tensor goes through f32 to
the config's dtype, as in the JAX package. No Pallas kernel is reached in
the JAX package here (XLA convolutions and plain attention), so the port
runs plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.ops.attention import multi_head_attention

CLIP_LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Draws:
    """Seeded parameter draws on one device: truncated normals at +-2 std
    (the JAX package's ``trunc_normal``), zeros and ones."""

    def __init__(self, seed: int, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def trunc_normal(self, shape, std: float = 0.02) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=self.gen)
        return t.to(self.dtype)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def dense(self, d_in: int, d_out: int) -> Dict[str, torch.Tensor]:
        return {"kernel": self.trunc_normal((d_in, d_out), d_in ** -0.5),
                "bias": self.const((d_out,), 0.0)}

    def layer_norm(self, d: int) -> Dict[str, torch.Tensor]:
        return {"scale": self.const((d,), 1.0), "bias": self.const((d,), 0.0)}


# ======================================================================
# ViT image tower
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ClipViTConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    dtype: Any = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def b32() -> "ClipViTConfig":
        return ClipViTConfig()

    @staticmethod
    def b16() -> "ClipViTConfig":
        return ClipViTConfig(patch_size=16)

    @staticmethod
    def l14() -> "ClipViTConfig":
        return ClipViTConfig(
            patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, projection_dim=768,
        )

    @staticmethod
    def tiny(**overrides) -> "ClipViTConfig":
        base = dict(
            image_size=28, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=64, projection_dim=16,
        )
        base.update(overrides)
        return ClipViTConfig(**base)


def _init_clip_block(draw: _Draws, d: int, inter: int) -> Dict[str, Any]:
    return {
        "ln1": draw.layer_norm(d),
        "q": draw.dense(d, d), "k": draw.dense(d, d), "v": draw.dense(d, d),
        "out": draw.dense(d, d),
        "ln2": draw.layer_norm(d),
        "fc1": draw.dense(d, inter), "fc2": draw.dense(inter, d),
    }


def _clip_block(lp, x: torch.Tensor, num_heads: int,
                causal_mask: Optional[torch.Tensor]) -> torch.Tensor:
    b, s, d = x.shape
    dh = d // num_heads
    h = L.layer_norm(lp["ln1"], x, CLIP_LN_EPS)
    q = L.dense(lp["q"], h).reshape(b, s, num_heads, dh)
    k = L.dense(lp["k"], h).reshape(b, s, num_heads, dh)
    v = L.dense(lp["v"], h).reshape(b, s, num_heads, dh)
    attn = multi_head_attention(q, k, v, causal_mask)
    x = x + L.dense(lp["out"], attn.reshape(b, s, d))
    h = L.layer_norm(lp["ln2"], x, CLIP_LN_EPS)
    return x + L.dense(lp["fc2"], quick_gelu(L.dense(lp["fc1"], h)))


def init_clip_vit(seed: int, cfg: ClipViTConfig, device="cpu") -> Dict[str, Any]:
    draw = _Draws(seed, device, cfg.dtype)
    patch_in = 3 * cfg.patch_size * cfg.patch_size
    return {
        # CLIP's patch conv has no bias
        "patch_embed": {"kernel": draw.trunc_normal((patch_in, cfg.hidden_size))},
        "class_embedding": draw.trunc_normal((cfg.hidden_size,)),
        "pos_embed": draw.trunc_normal((cfg.seq_len, cfg.hidden_size)),
        "ln_pre": draw.layer_norm(cfg.hidden_size),
        "layers": [_init_clip_block(draw, cfg.hidden_size, cfg.intermediate_size)
                   for _ in range(cfg.num_layers)],
        "ln_post": draw.layer_norm(cfg.hidden_size),
        "proj": draw.trunc_normal((cfg.hidden_size, cfg.projection_dim)),
    }


def clip_vit_image(params: Dict[str, Any], cfg: ClipViTConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (CLIP-normalized) -> embeddings [B, proj]."""
    b, _, _, c = images.shape
    p, g = cfg.patch_size, cfg.grid
    x = images.to(cfg.dtype).reshape(b, g, p, g, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, c * p * p)
    x = L.dense(params["patch_embed"], x)
    cls = params["class_embedding"][None, None].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = L.layer_norm(params["ln_pre"], x, CLIP_LN_EPS)
    for lp in params["layers"]:
        x = _clip_block(lp, x, cfg.num_heads, None)
    pooled = L.layer_norm(params["ln_post"], x[:, 0], CLIP_LN_EPS)
    return pooled @ params["proj"]


# ======================================================================
# text tower
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_len: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    projection_dim: int = 512
    dtype: Any = torch.float32

    @staticmethod
    def tiny(**overrides) -> "ClipTextConfig":
        base = dict(
            vocab_size=100, max_len=16, hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=64, projection_dim=16,
        )
        base.update(overrides)
        return ClipTextConfig(**base)


def init_clip_text(seed: int, cfg: ClipTextConfig, device="cpu") -> Dict[str, Any]:
    draw = _Draws(seed, device, cfg.dtype)
    return {
        "token_embedding": {"embedding": draw.trunc_normal((cfg.vocab_size, cfg.hidden_size))},
        "pos_embed": draw.trunc_normal((cfg.max_len, cfg.hidden_size)),
        "layers": [_init_clip_block(draw, cfg.hidden_size, cfg.intermediate_size)
                   for _ in range(cfg.num_layers)],
        "ln_final": draw.layer_norm(cfg.hidden_size),
        "proj": draw.trunc_normal((cfg.hidden_size, cfg.projection_dim)),
    }


def clip_text(params: Dict[str, Any], cfg: ClipTextConfig,
              token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [B, S] (EOT = max id in each row) -> embeddings [B, proj]."""
    b, s = token_ids.shape
    x = L.embed(params["token_embedding"], token_ids) + params["pos_embed"][:s][None]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None]
    for lp in params["layers"]:
        x = _clip_block(lp, x, cfg.num_heads, causal)
    x = L.layer_norm(params["ln_final"], x, CLIP_LN_EPS)
    # pool at the EOT token (highest token id, the CLIP convention)
    eot = torch.argmax(token_ids, dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot]
    return pooled @ params["proj"]


# ======================================================================
# modified ResNet image tower (RN50 / RN101)
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ClipResNetConfig:
    layers: tuple = (3, 4, 6, 3)  # RN50; RN101 = (3, 4, 23, 3)
    width: int = 64
    image_size: int = 224
    embed_dim: int = 1024  # RN50 attnpool output; RN101 = 512
    heads: int = 32
    dtype: Any = torch.float32

    @staticmethod
    def rn50() -> "ClipResNetConfig":
        return ClipResNetConfig()

    @staticmethod
    def rn101() -> "ClipResNetConfig":
        return ClipResNetConfig(layers=(3, 4, 23, 3), embed_dim=512)

    @staticmethod
    def tiny(**overrides) -> "ClipResNetConfig":
        base = dict(layers=(1, 1, 1, 1), width=8, image_size=32, embed_dim=32, heads=4)
        base.update(overrides)
        return ClipResNetConfig(**base)


def _init_conv(draw: _Draws, kh: int, kw: int, cin: int, cout: int) -> Dict[str, torch.Tensor]:
    return {"kernel": draw.trunc_normal((kh, kw, cin, cout), (kh * kw * cin) ** -0.5)}


def _init_bn(draw: _Draws, c: int) -> Dict[str, torch.Tensor]:
    return {"scale": draw.const((c,), 1.0), "bias": draw.const((c,), 0.0),
            "mean": draw.const((c,), 0.0), "var": draw.const((c,), 1.0)}


def _conv(params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Conv of NCHW ``x`` with the HWIO kernel (permuted to OIHW here), with
    torch-style symmetric padding ((k-1)//2 a side), as the JAX package's
    explicit padding."""
    kernel = params["kernel"]
    kh, kw = kernel.shape[:2]
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride,
                    padding=((kh - 1) // 2, (kw - 1) // 2))


def _bn(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm of NCHW ``x`` from the running statistics, in f32."""
    def per_channel(name):
        return params[name].float()[None, :, None, None]

    inv = torch.rsqrt(per_channel("var") + eps)
    out = (x.float() - per_channel("mean")) * inv
    return (out * per_channel("scale") + per_channel("bias")).to(x.dtype)


def _avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x, window, window)


def _init_bottleneck(draw: _Draws, cin: int, cout: int, stride: int) -> Dict[str, Any]:
    expansion = 4
    params = {
        "conv1": _init_conv(draw, 1, 1, cin, cout), "bn1": _init_bn(draw, cout),
        "conv2": _init_conv(draw, 3, 3, cout, cout), "bn2": _init_bn(draw, cout),
        "conv3": _init_conv(draw, 1, 1, cout, cout * expansion),
        "bn3": _init_bn(draw, cout * expansion),
    }
    if stride > 1 or cin != cout * expansion:
        params["downsample"] = {"conv": _init_conv(draw, 1, 1, cin, cout * expansion),
                                "bn": _init_bn(draw, cout * expansion)}
    return params


def _bottleneck(lp, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(_bn(lp["bn1"], _conv(lp["conv1"], x)))
    out = F.relu(_bn(lp["bn2"], _conv(lp["conv2"], out)))
    if stride > 1:  # CLIP: avgpool *before* conv3 (anti-aliased downsample)
        out = _avg_pool(out, stride)
    out = _bn(lp["bn3"], _conv(lp["conv3"], out))
    identity = x
    if "downsample" in lp:
        if stride > 1:
            identity = _avg_pool(identity, stride)
        identity = _bn(lp["downsample"]["bn"], _conv(lp["downsample"]["conv"], identity))
    return F.relu(out + identity)


def _stride(stage: int, block: int) -> int:
    return 1 if (block > 0 or stage == 0) else 2


def init_clip_resnet(seed: int, cfg: ClipResNetConfig, device="cpu") -> Dict[str, Any]:
    w = cfg.width
    draw = _Draws(seed, device, cfg.dtype)
    params: Dict[str, Any] = {
        "conv1": _init_conv(draw, 3, 3, 3, w // 2), "bn1": _init_bn(draw, w // 2),
        "conv2": _init_conv(draw, 3, 3, w // 2, w // 2), "bn2": _init_bn(draw, w // 2),
        "conv3": _init_conv(draw, 3, 3, w // 2, w), "bn3": _init_bn(draw, w),
    }
    cin = w
    for stage, blocks in enumerate(cfg.layers):
        cout = w * (2 ** stage)
        stage_params = []
        for b in range(blocks):
            stage_params.append(_init_bottleneck(draw, cin, cout, _stride(stage, b)))
            cin = cout * 4
        params[f"layer{stage + 1}"] = stage_params

    # attention pool head
    spatial = cfg.image_size // 32
    embed_in = w * 8 * 4
    params["attnpool"] = {
        "pos_embed": draw.trunc_normal((spatial * spatial + 1, embed_in)),
        "q": draw.dense(embed_in, embed_in),
        "k": draw.dense(embed_in, embed_in),
        "v": draw.dense(embed_in, embed_in),
        "proj": draw.dense(embed_in, cfg.embed_dim),
    }
    return params


def clip_resnet_image(params: Dict[str, Any], cfg: ClipResNetConfig,
                      images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] -> embeddings [B, embed_dim]. The tower runs in
    NCHW (one permute in)."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    # 3-conv stem, stride-2 first conv, avgpool at the end
    x = F.relu(_bn(params["bn1"], _conv(params["conv1"], x, stride=2)))
    x = F.relu(_bn(params["bn2"], _conv(params["conv2"], x)))
    x = F.relu(_bn(params["bn3"], _conv(params["conv3"], x)))
    x = _avg_pool(x, 2)
    for stage in range(4):
        for b, lp in enumerate(params[f"layer{stage + 1}"]):
            x = _bottleneck(lp, x, _stride(stage, b))

    # attention pooling: the mean token queries the spatial grid
    b, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)  # [B, H*W, C], row-major as NHWC
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    ap = params["attnpool"]
    tokens = tokens + ap["pos_embed"][None]
    heads = cfg.heads
    dh = c // heads
    q = L.dense(ap["q"], tokens[:, :1]).reshape(b, 1, heads, dh)
    k = L.dense(ap["k"], tokens).reshape(b, -1, heads, dh)
    v = L.dense(ap["v"], tokens).reshape(b, -1, heads, dh)
    pooled = multi_head_attention(q, k, v).reshape(b, c)
    return L.dense(ap["proj"], pooled)


# ======================================================================
# converters
# ======================================================================
def _leaf(t, dtype, device) -> torch.Tensor:
    """A source tensor (torch or numpy) through f32 to ``dtype`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.detach().to(device=device, dtype=torch.float32).to(dtype).contiguous()


def convert_hf_clip(sd: Mapping[str, Any], vit_cfg: ClipViTConfig, text_cfg: ClipTextConfig,
                    device="cpu") -> Dict[str, Dict[str, Any]]:
    """HF ``CLIPModel`` state dict -> {"vision": ..., "text": ...}: the
    ``vit_cfg.num_layers`` vision blocks and ``text_cfg.num_layers`` text
    blocks; leaves in ``vit_cfg.dtype`` on ``device``."""
    dt = vit_cfg.dtype

    def arr(key, transpose=False):
        t = _leaf(sd[key], dt, device)
        return t.T.contiguous() if transpose else t

    def lin(prefix):
        return {"kernel": arr(prefix + ".weight", transpose=True), "bias": arr(prefix + ".bias")}

    def ln(prefix):
        return {"scale": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    def block(prefix):
        return {
            "ln1": ln(prefix + ".layer_norm1"),
            "q": lin(prefix + ".self_attn.q_proj"),
            "k": lin(prefix + ".self_attn.k_proj"),
            "v": lin(prefix + ".self_attn.v_proj"),
            "out": lin(prefix + ".self_attn.out_proj"),
            "ln2": ln(prefix + ".layer_norm2"),
            "fc1": lin(prefix + ".mlp.fc1"),
            "fc2": lin(prefix + ".mlp.fc2"),
        }

    conv = arr("vision_model.embeddings.patch_embedding.weight")  # [D, C, P, P]
    vision = {
        "patch_embed": {"kernel": conv.reshape(conv.shape[0], -1).T.contiguous()},
        "class_embedding": arr("vision_model.embeddings.class_embedding"),
        "pos_embed": arr("vision_model.embeddings.position_embedding.weight"),
        "ln_pre": ln("vision_model.pre_layrnorm")
        if "vision_model.pre_layrnorm.weight" in sd
        else ln("vision_model.pre_layernorm"),
        "layers": [block(f"vision_model.encoder.layers.{i}") for i in range(vit_cfg.num_layers)],
        "ln_post": ln("vision_model.post_layernorm"),
        "proj": arr("visual_projection.weight", transpose=True),
    }
    tdt = text_cfg.dtype
    text = {
        "token_embedding": {
            "embedding": _leaf(sd["text_model.embeddings.token_embedding.weight"], tdt, device)},
        "pos_embed": _leaf(sd["text_model.embeddings.position_embedding.weight"], tdt, device),
        "layers": [block(f"text_model.encoder.layers.{i}") for i in range(text_cfg.num_layers)],
        "ln_final": ln("text_model.final_layer_norm"),
        "proj": _leaf(sd["text_projection.weight"], tdt, device).T.contiguous(),
    }
    return {"vision": vision, "text": text}


def convert_openai_clip_resnet(sd: Mapping[str, Any], cfg: ClipResNetConfig,
                               device="cpu") -> Dict[str, Any]:
    """OpenAI CLIP ``visual.*`` ResNet state dict -> the ``init_clip_resnet``
    tree: conv kernels [O, I, kh, kw] -> HWIO; BatchNorm running statistics;
    ``downsample`` is OpenAI's AvgPool("-1") + Conv("0") + BN("1"); the
    attention pool's q/k/v/c_proj and positional embedding."""
    dt = cfg.dtype

    def conv(key):
        return {"kernel": _leaf(sd[key + ".weight"], dt, device).permute(2, 3, 1, 0).contiguous()}

    def bn(key):
        return {"scale": _leaf(sd[key + ".weight"], dt, device),
                "bias": _leaf(sd[key + ".bias"], dt, device),
                "mean": _leaf(sd[key + ".running_mean"], dt, device),
                "var": _leaf(sd[key + ".running_var"], dt, device)}

    def lin(key):
        return {"kernel": _leaf(sd[key + ".weight"], dt, device).T.contiguous(),
                "bias": _leaf(sd[key + ".bias"], dt, device)}

    params: Dict[str, Any] = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = conv(f"visual.conv{i}")
        params[f"bn{i}"] = bn(f"visual.bn{i}")

    for stage, blocks in enumerate(cfg.layers):
        stage_params = []
        for b in range(blocks):
            base = f"visual.layer{stage + 1}.{b}"
            lp = {
                "conv1": conv(base + ".conv1"), "bn1": bn(base + ".bn1"),
                "conv2": conv(base + ".conv2"), "bn2": bn(base + ".bn2"),
                "conv3": conv(base + ".conv3"), "bn3": bn(base + ".bn3"),
            }
            if base + ".downsample.0.weight" in sd:
                lp["downsample"] = {"conv": conv(base + ".downsample.0"),
                                    "bn": bn(base + ".downsample.1")}
            stage_params.append(lp)
        params[f"layer{stage + 1}"] = stage_params

    params["attnpool"] = {
        "pos_embed": _leaf(sd["visual.attnpool.positional_embedding"], dt, device),
        "q": lin("visual.attnpool.q_proj"),
        "k": lin("visual.attnpool.k_proj"),
        "v": lin("visual.attnpool.v_proj"),
        "proj": lin("visual.attnpool.c_proj"),
    }
    return params
