"""PyTorch checkpoints -> the port's parameter trees.

Port of ``certifiedgpt_tpu/models/convert.py``. MiniGPT-4 is assembled from
four checkpoint families: a Vicuna HF directory, ``eva_vit_g.pth``, the
BLIP-2 Q-Former and the MiniGPT-4 stage-2 ``model_state_dict``. Each
converter maps one family's state dict (torch tensors or numpy arrays, e.g.
``torch.load`` results or a ``safetensors_io.SafetensorsDir``) onto the
tree of its tower: torch's ``[out, in]`` Linear weights become ``[in, out]``
kernels, per-layer weights are stacked on a leading ``[L, ...]`` axis.

Every leaf goes through f32 to the config's dtype on ``device`` (the JAX
package's chain: torch tensor -> f32 numpy -> ``jnp.asarray(dtype=...)``;
both casts round to nearest even, so the bits are the same). Stacks are
filled one layer at a time on the device, so the device holds the finished
tree plus one layer; with ``quantize`` each layer kernel is quantized to the
serving int8 layout as it is filled (``ops.quantization.quantize_kernel``
of the kernel in the config's dtype: the JAX ``quantize_llama`` /
``quantize_eva_vit`` after the conversion).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops.quantization import int8_kernel_layout, quantize_kernel

#: the ViT layer kernels the serving int8 layout quantizes (``quantize_eva_vit``)
VIT_QUANTIZED = ("qkv", "proj", "fc1", "fc2")


def _f32(tensor, device) -> torch.Tensor:
    if isinstance(tensor, np.ndarray):
        tensor = torch.from_numpy(np.ascontiguousarray(tensor))
    return torch.as_tensor(tensor).detach().to(device).float()


def _kernel(tensor, dtype, device) -> torch.Tensor:
    """torch Linear.weight [out, in] -> kernel [in, out]."""
    return _f32(tensor, device).T.to(dtype).contiguous()


def _vec(tensor, dtype, device) -> torch.Tensor:
    return _f32(tensor, device).to(dtype)


def _stack(n: int, leaf: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """``[n, ...]`` from ``leaf(i)``, filled one layer at a time."""
    first = leaf(0)
    out = torch.empty((n,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    out[0].copy_(first)
    for i in range(1, n):
        out[i].copy_(leaf(i))
    return out


def _stack_kernels(n: int, weight: Callable[[int], Any], dtype, device,
                   quantize: bool) -> Dict[str, torch.Tensor]:
    """The ``[n, in, out]`` kernels of ``weight(i)`` (torch layout): float in
    ``dtype``, or with ``quantize`` int8 codes (column-major, as
    the int8 kernels take them) and per-(layer, out-channel) f32 scales."""
    if not quantize:
        return {"kernel": _stack(n, lambda i: _kernel(weight(i), dtype, device))}
    first = _kernel(weight(0), dtype, device)
    kq = int8_kernel_layout(torch.empty((n,) + tuple(first.shape), dtype=torch.int8,
                                        device=first.device))
    scale = torch.empty((n, first.shape[1]), dtype=torch.float32, device=first.device)
    for i in range(n):
        q = quantize_kernel(first if i == 0 else _kernel(weight(i), dtype, device))
        kq[i].copy_(q["kernel_q"])
        scale[i].copy_(q["scale"])
    return {"kernel_q": kq, "scale": scale}


# ----------------------------------------------------------------------
# LLaMA / Vicuna (HF LlamaForCausalLM state dict)
# ----------------------------------------------------------------------
LLAMA_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
LLAMA_MLP = ("gate_proj", "up_proj", "down_proj")


def convert_llama_state_dict(sd, cfg, device="cpu", quantize: bool = False) -> Dict[str, Any]:
    """HF ``LlamaForCausalLM`` state dict -> the decoder tree.

    Takes ``model.``-prefixed (ForCausalLM) and bare (LlamaModel) keys; the
    ``lm_head`` falls back to the tied embeddings when absent. With
    ``quantize`` the layer kernels are int8 (``quantize_llama``)."""
    dt, n = cfg.dtype, cfg.num_layers
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(key):
        return sd[prefix + key]

    def weight(path):
        return lambda i: g(f"layers.{i}.{path}.weight")

    layers = {"input_layernorm": {"scale": _stack(
        n, lambda i: _vec(g(f"layers.{i}.input_layernorm.weight"), dt, device))}}
    for name in LLAMA_ATTN:
        layers[name] = _stack_kernels(n, weight(f"self_attn.{name}"), dt, device, quantize)
    layers["post_attention_layernorm"] = {"scale": _stack(
        n, lambda i: _vec(g(f"layers.{i}.post_attention_layernorm.weight"), dt, device))}
    for name in LLAMA_MLP:
        layers[name] = _stack_kernels(n, weight(f"mlp.{name}"), dt, device, quantize)

    head = sd["lm_head.weight"] if "lm_head.weight" in sd else g("embed_tokens.weight")
    return {
        "embed_tokens": {"embedding": _vec(g("embed_tokens.weight"), dt, device)},
        "layers": layers,
        "norm": {"scale": _vec(g("norm.weight"), dt, device)},
        "lm_head": {"kernel": _kernel(head, dt, device)},
    }


# ----------------------------------------------------------------------
# Q-Former (BLIP-2 checkpoint or HF Blip2QFormerModel state dict)
# ----------------------------------------------------------------------
def convert_qformer_state_dict(sd, cfg, prefix: str = "", device="cpu") -> Dict[str, Any]:
    """BLIP-2 Q-Former torch weights -> the Q-Former tree.

    Both key dialects: the vendored-BERT naming of the BLIP-2 checkpoint
    (``Qformer.bert.encoder.layer.{i}.attention.self.query...``, a root
    ``query_tokens``) and HF ``Blip2QFormerModel``'s
    (``encoder.layer.{i}.attention.attention.query...``, the embeddings LN at
    ``layernorm.*``). ``prefix`` strips a leading scope (e.g.
    ``"Qformer.bert."``); keys outside it are dropped, except the root
    ``query_tokens``. The text branch (``intermediate``/``output``), the word
    and position embeddings and the LM head are converted when present."""
    dt = cfg.dtype
    query_raw = sd.get("query_tokens")
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)} if prefix \
        else dict(sd)
    if query_raw is not None:
        sd["query_tokens"] = query_raw

    hf_style = any("attention.attention.query" in k for k in sd)
    self_scope = "attention.attention" if hf_style else "attention.self"
    cross_scope = "crossattention.attention" if hf_style else "crossattention.self"

    def lin(key):
        return {"kernel": _kernel(sd[key + ".weight"], dt, device),
                "bias": _vec(sd[key + ".bias"], dt, device)}

    def ln(key):
        return {"scale": _vec(sd[key + ".weight"], dt, device),
                "bias": _vec(sd[key + ".bias"], dt, device)}

    emb_ln = ln("layernorm") if "layernorm.weight" in sd else ln("embeddings.LayerNorm")

    layers = {}
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}."
        lp = {
            "self_q": lin(base + self_scope + ".query"),
            "self_k": lin(base + self_scope + ".key"),
            "self_v": lin(base + self_scope + ".value"),
            "self_out": lin(base + "attention.output.dense"),
            "self_ln": ln(base + "attention.output.LayerNorm"),
            "int_q": lin(base + "intermediate_query.dense"),
            "out_q": lin(base + "output_query.dense"),
            "ffn_ln_q": ln(base + "output_query.LayerNorm"),
        }
        if cfg.has_cross_attention(i):
            lp.update({
                "cross_q": lin(base + cross_scope + ".query"),
                "cross_k": lin(base + cross_scope + ".key"),
                "cross_v": lin(base + cross_scope + ".value"),
                "cross_out": lin(base + "crossattention.output.dense"),
                "cross_ln": ln(base + "crossattention.output.LayerNorm"),
            })
        # the text feed-forward branch, absent where MiniGPT-4 pruned it
        if base + "intermediate.dense.weight" in sd:
            lp["int_txt"] = lin(base + "intermediate.dense")
            lp["out_txt"] = lin(base + "output.dense")
            lp["ffn_ln_txt"] = ln(base + "output.LayerNorm")
        layers[f"layer_{i}"] = lp

    params = {"embeddings_ln": emb_ln, "layers": layers}
    if "query_tokens" in sd:
        # HF keeps the query tokens on the wrapping Blip2 model: the caller
        # supplies them when the state dict has none
        params["query_tokens"] = _vec(sd["query_tokens"], dt, device)
    if "embeddings.word_embeddings.weight" in sd:
        params["word_embeddings"] = {
            "embedding": _vec(sd["embeddings.word_embeddings.weight"], dt, device)}
        params["position_embeddings"] = {
            "embedding": _vec(sd["embeddings.position_embeddings.weight"], dt, device)}
    if "cls.predictions.transform.dense.weight" in sd:
        params["cls_transform"] = lin("cls.predictions.transform.dense")
        params["cls_ln"] = ln("cls.predictions.transform.LayerNorm")
        params["cls_bias"] = _vec(sd["cls.predictions.bias"], dt, device)
    return params


# ----------------------------------------------------------------------
# MiniGPT-4 stage 2 (llama_proj, ln_vision)
# ----------------------------------------------------------------------
def load_projection(params: Dict[str, Any], sd: Mapping[str, Any], device="cuda") -> None:
    """Write a stage-2 checkpoint's ``llama_proj`` (f32) and ``ln_vision``
    (in the tree's dtype) into ``params``."""
    for key, value in sd.items():
        if key.endswith("llama_proj.weight"):
            params["llama_proj"]["kernel"] = _kernel(value, torch.float32, device)
        elif key.endswith("llama_proj.bias"):
            params["llama_proj"]["bias"] = _vec(value, torch.float32, device)
        elif key.endswith("ln_vision.weight"):
            params["ln_vision"]["scale"] = _vec(value, params["ln_vision"]["scale"].dtype, device)
        elif key.endswith("ln_vision.bias"):
            params["ln_vision"]["bias"] = _vec(value, params["ln_vision"]["bias"].dtype, device)


# ----------------------------------------------------------------------
# EVA ViT (eva_vit_g.pth, BEiT naming)
# ----------------------------------------------------------------------
def interpolate_pos_embed(pos_embed, target_num_patches: int) -> torch.Tensor:
    """The position table resampled to ``target_num_patches`` patches, as an
    f32 CPU tensor ``[1, extra + patches, D]``: the extra (cls) entries are
    kept, the patch grid is resized by ``F.interpolate`` (bicubic, Keys
    a = -0.75, ``align_corners=False``) on the CPU in f32, as the JAX
    package does."""
    pos = _f32(pos_embed, "cpu")
    if pos.ndim == 3:
        pos = pos[0]
    num_extra = pos.shape[0] - int(round((pos.shape[0] - 1) ** 0.5)) ** 2
    grid_old = int(round((pos.shape[0] - num_extra) ** 0.5))
    grid_new = int(round(target_num_patches ** 0.5))
    if grid_old == grid_new:
        return pos[None]
    extra, patch = pos[:num_extra], pos[num_extra:]
    dim = pos.shape[-1]
    grid = patch.reshape(grid_old, grid_old, dim).permute(2, 0, 1)[None]  # [1, D, G, G]
    resized = F.interpolate(grid, size=(grid_new, grid_new), mode="bicubic",
                            align_corners=False)
    resized = resized[0].permute(1, 2, 0).reshape(grid_new * grid_new, dim)
    return torch.cat([extra, resized], dim=0)[None]


def convert_eva_vit_state_dict(sd, cfg, device="cpu", quantize: bool = False) -> Dict[str, Any]:
    """``eva_vit_g.pth`` state dict -> the ViT tree.

    Torch layout: ``patch_embed.proj.weight`` [D, C, P, P] (Conv2d),
    ``blocks.{i}.attn.qkv.weight`` [3D, D] biasless with separate
    ``q_bias``/``v_bias``. The position table is resampled to the
    configured image size when its grid differs. With ``quantize`` the
    qkv/proj/fc1/fc2 kernels are int8 (``quantize_eva_vit``)."""
    dt, d, n = cfg.dtype, cfg.embed_dim, cfg.depth

    def block(path):
        return lambda i: sd[f"blocks.{i}.{path}"]

    def vecs(path):
        return _stack(n, lambda i: _vec(sd[f"blocks.{i}.{path}"], dt, device))

    def dense(name, path, bias=True):
        p = {"bias": vecs(path + ".bias")} if bias else {}
        p.update(_stack_kernels(n, block(path + ".weight"), dt, device,
                                quantize and name in VIT_QUANTIZED))
        return p

    conv = _f32(sd["patch_embed.proj.weight"], device)  # [D, C, P, P]
    pos = interpolate_pos_embed(sd["pos_embed"], cfg.num_patches)
    return {
        "patch_embed": {"kernel": conv.reshape(d, -1).T.to(dt).contiguous(),
                        "bias": _vec(sd["patch_embed.proj.bias"], dt, device)},
        "cls_token": _vec(sd["cls_token"], dt, device),
        "pos_embed": pos.to(device).to(dt),
        "layers": {
            "norm1": {"scale": vecs("norm1.weight"), "bias": vecs("norm1.bias")},
            "qkv": dense("qkv", "attn.qkv", bias=False),
            "q_bias": vecs("attn.q_bias"),
            "v_bias": vecs("attn.v_bias"),
            "proj": dense("proj", "attn.proj"),
            "norm2": {"scale": vecs("norm2.weight"), "bias": vecs("norm2.bias")},
            "fc1": dense("fc1", "mlp.fc1"),
            "fc2": dense("fc2", "mlp.fc2"),
        },
    }
