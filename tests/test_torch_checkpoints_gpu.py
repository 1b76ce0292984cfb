"""Checkpoint loading on the card: the four checkpoint families at tiny
widths, loaded by ``MiniGPT4Model.from_config`` (and the Vicuna shards by
``load_llama_dir``) onto the card, equal the same files loaded onto the CPU
leaf for leaf, with and without the int8 layer kernels and at bf16. The
state-dict writers here (upstream key layouts at the widths of
``MiniGPT4Config.tiny()``) also serve ``test_torch_checkpoints.py``. Tests
marked ``gpu`` skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so on the GPU machine it runs without the
conftest:

    python -m pytest --noconftest tests/test_torch_checkpoints_gpu.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from certifiedgpt_tpu_torch.models import model_zoo as TZ
from certifiedgpt_tpu_torch.models.safetensors_io import INDEX_FILE

# tiny widths of MiniGPT4Config.tiny(): ViT 32 wide, 2 layers, a 2x2 patch
# grid; Q-Former 32 wide, 4 layers, 8 queries; decoder 64 wide, 2 layers
VIT_D, VIT_DEPTH, VIT_MLP, VIT_GRID, CKPT_GRID = 32, 2, 64, 2, 4
Q_D, Q_LAYERS, Q_INTER, Q_VOCAB, Q_POS, Q_QUERIES = 32, 4, 64, 64, 32, 8
L_VOCAB, L_D, L_INTER, L_LAYERS, L_HEADS = 256, 64, 128, 2, 4


def _randn(rng, *shape, std=0.1, dtype=torch.float32):
    return torch.from_numpy((std * rng.randn(*shape)).astype(np.float32)).to(dtype)


def eva_state_dict(rng, dtype=torch.float16, grid=CKPT_GRID):
    """``eva_vit_g.pth`` naming: Conv2d patch embedding, fused biasless qkv
    with q/v biases, the position table at ``grid`` x ``grid`` patches."""
    d, p = VIT_D, 14

    def r(*shape, offset=0.0):
        return offset + _randn(rng, *shape, dtype=dtype)

    sd = {"patch_embed.proj.weight": r(d, 3, p, p), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, grid * grid + 1, d)}
    for i in range(VIT_DEPTH):
        b = f"blocks.{i}."
        sd.update({
            b + "norm1.weight": r(d, offset=1.0), b + "norm1.bias": r(d),
            b + "attn.qkv.weight": r(3 * d, d), b + "attn.q_bias": r(d), b + "attn.v_bias": r(d),
            b + "attn.proj.weight": r(d, d), b + "attn.proj.bias": r(d),
            b + "norm2.weight": r(d, offset=1.0), b + "norm2.bias": r(d),
            b + "mlp.fc1.weight": r(VIT_MLP, d), b + "mlp.fc1.bias": r(VIT_MLP),
            b + "mlp.fc2.weight": r(d, VIT_MLP), b + "mlp.fc2.bias": r(d),
        })
    return sd


def qformer_state_dict(rng, hf_style=False, text=True, head=True):
    """A Q-Former state dict without scope: the vendored-BERT dialect
    (``attention.self``, ``embeddings.LayerNorm``, a ``query_tokens``) or
    HF ``Blip2QFormerModel``'s (``attention.attention``, ``layernorm``, no
    query tokens), with or without the text branch and the LM head."""
    d, sd = Q_D, {}

    def lin(key, d_out, d_in):
        sd[key + ".weight"] = _randn(rng, d_out, d_in)
        sd[key + ".bias"] = _randn(rng, d_out)

    def ln(key):
        sd[key + ".weight"] = 1 + _randn(rng, d)
        sd[key + ".bias"] = _randn(rng, d)

    scope = "attention.attention" if hf_style else "attention.self"
    cross = "crossattention.attention" if hf_style else "crossattention.self"
    ln("layernorm" if hf_style else "embeddings.LayerNorm")
    for i in range(Q_LAYERS):
        b = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            lin(f"{b}{scope}.{name}", d, d)
        lin(b + "attention.output.dense", d, d)
        ln(b + "attention.output.LayerNorm")
        if i % 2 == 0:
            lin(f"{b}{cross}.query", d, d)
            lin(f"{b}{cross}.key", d, VIT_D)
            lin(f"{b}{cross}.value", d, VIT_D)
            lin(b + "crossattention.output.dense", d, d)
            ln(b + "crossattention.output.LayerNorm")
        lin(b + "intermediate_query.dense", Q_INTER, d)
        lin(b + "output_query.dense", d, Q_INTER)
        ln(b + "output_query.LayerNorm")
        if text:
            lin(b + "intermediate.dense", Q_INTER, d)
            lin(b + "output.dense", d, Q_INTER)
            ln(b + "output.LayerNorm")
    if text:
        sd["embeddings.word_embeddings.weight"] = _randn(rng, Q_VOCAB, d)
        sd["embeddings.position_embeddings.weight"] = _randn(rng, Q_POS, d)
    if head:
        lin("cls.predictions.transform.dense", d, d)
        ln("cls.predictions.transform.LayerNorm")
        sd["cls.predictions.bias"] = _randn(rng, Q_VOCAB)
    if not hf_style:
        sd["query_tokens"] = _randn(rng, 1, Q_QUERIES, d)
    return sd


def blip2_checkpoint(rng):
    """The BLIP-2 ``.pth`` layout: ``{"model": ...}`` with the Q-Former under
    ``Qformer.bert.``, ``query_tokens`` at the root, and keys of other
    modules that the loader drops."""
    sd = qformer_state_dict(rng, head=False)
    query = sd.pop("query_tokens")
    model = {"Qformer.bert." + k: v for k, v in sd.items()}
    model.update({"query_tokens": query,
                  "visual_encoder.cls_token": _randn(rng, 1, 1, VIT_D),
                  "visual_encoder.blocks.0.norm1.weight": _randn(rng, VIT_D),
                  "t5_proj.weight": _randn(rng, 16, Q_D), "t5_proj.bias": _randn(rng, 16)})
    return {"model": model}


def llama_state_dict(rng, dtype=torch.float16, prefix="model.", head=True):
    d, sd = L_D, {}
    sd[prefix + "embed_tokens.weight"] = _randn(rng, L_VOCAB, d, dtype=dtype)
    for i in range(L_LAYERS):
        b = f"{prefix}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{b}self_attn.{name}.weight"] = _randn(rng, d, d, dtype=dtype)
        sd[b + "mlp.gate_proj.weight"] = _randn(rng, L_INTER, d, dtype=dtype)
        sd[b + "mlp.up_proj.weight"] = _randn(rng, L_INTER, d, dtype=dtype)
        sd[b + "mlp.down_proj.weight"] = _randn(rng, d, L_INTER, dtype=dtype)
        sd[b + "input_layernorm.weight"] = 1 + _randn(rng, d, dtype=dtype)
        sd[b + "post_attention_layernorm.weight"] = 1 + _randn(rng, d, dtype=dtype)
    sd[prefix + "norm.weight"] = 1 + _randn(rng, d, dtype=dtype)
    if head:
        sd["lm_head.weight"] = _randn(rng, L_VOCAB, d, dtype=dtype)
    return sd


def write_vicuna_shards(path, sd) -> None:
    """``sd`` as two safetensors shards with ``model.safetensors.index.json``."""
    from safetensors.torch import save_file

    path.mkdir(parents=True, exist_ok=True)
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, part in shards.items():
        save_file({k: sd[k].contiguous() for k in part}, str(path / name),
                  metadata={"format": "pt"})
    weight_map = {k: name for name, part in shards.items() for k in part}
    (path / INDEX_FILE).write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda", 0)


def assert_same_tree(on_card, on_cpu, path=""):
    if isinstance(on_cpu, dict):
        assert sorted(on_card) == sorted(on_cpu), path
        for key in on_cpu:
            assert_same_tree(on_card[key], on_cpu[key], f"{path}/{key}")
        return
    assert on_card.device.type == "cuda" and on_card.dtype == on_cpu.dtype, path
    assert torch.equal(on_card.cpu(), on_cpu), path


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True])
def test_loads_on_the_card_as_on_the_cpu(cuda, tmp_path, quantize):
    pytest.importorskip("safetensors")
    rng = np.random.RandomState(0)
    paths = {"eva_vit_g_pth": str(tmp_path / "eva_vit_g.pth"),
             "q_former_model": str(tmp_path / "blip2.pth"), "ckpt": str(tmp_path / "stage2.pth")}
    torch.save(eva_state_dict(rng), paths["eva_vit_g_pth"])
    torch.save(blip2_checkpoint(rng), paths["q_former_model"])
    torch.save({"model": {"llama_proj.weight": _randn(rng, L_D, Q_D),
                          "llama_proj.bias": _randn(rng, L_D),
                          "ln_vision.weight": 1 + _randn(rng, VIT_D),
                          "ln_vision.bias": _randn(rng, VIT_D)}}, paths["ckpt"])
    block = {"model_size": "tiny", "quantize_vit": quantize, "quantize_llama": quantize, **paths}
    on_card = TZ.MiniGPT4Model.from_config(block, cuda).params
    on_cpu = TZ.MiniGPT4Model.from_config(block, "cpu").params
    for key in ("vit", "qformer", "llama_proj", "ln_vision"):
        assert_same_tree(on_card[key], on_cpu[key], key)
    if quantize:  # torch._int_mm's operand layout
        assert on_card["vit"]["layers"]["qkv"]["kernel_q"][0].stride()[0] == 1

    vicuna = tmp_path / "vicuna"
    write_vicuna_shards(vicuna, llama_state_dict(rng))
    cfg = TZ.config_from_block({"model_size": "tiny"}).llama
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        assert_same_tree(TZ.load_llama_dir(str(vicuna), cfg, cuda, quantize),
                         TZ.load_llama_dir(str(vicuna), cfg, "cpu", quantize), "llama")
