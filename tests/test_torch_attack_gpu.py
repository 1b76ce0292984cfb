"""The attack stage on the card.

Tests marked ``gpu`` hold a tiny W8A8 victim's caption at batch 1 through
the kernels (cls-split ViT at 224 px, both row-quant kernels; one launch a
layer each of the ViT's streams) against the same caption through their
plain versions, a PGD step of tiny surrogates on the card against the CPU
(with TF32 left on by the caller: the surrogates stay f32), the PGD loop
replayed from its CUDA graph against the same step run eagerly, and the
agent end to end on the card. They skip where there is no CUDA device. This file
imports neither JAX nor the JAX package, so on the GPU machine it runs
without the conftest:

    python -m pytest --noconftest tests/test_torch_attack_gpu.py -q
"""

import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from certifiedgpt_tpu_torch import registration  # noqa: F401
from certifiedgpt_tpu_torch.agents import base as TB
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.attack import agent as TAG
from certifiedgpt_tpu_torch.attack import attack as TA
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import eva_vit as V
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_params
from certifiedgpt_tpu_torch.ops import flash_attention as FA
from certifiedgpt_tpu_torch.ops import quantization as Q

from chip_smoke import tree_to

INSTRUCTION = "<Img><ImageHere></Img> Describe this image."


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda")


def kernel_victim(device):
    """A tiny MiniGPT-4 with the serving knobs: int8 ViT at 224 px (256
    patches) under the cls-split form with W8A8 activations, int8 W8A8
    decoder, int8 KV cache."""
    cfg = TM.MiniGPT4Config.tiny()
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, img_size=224, attn_impl="flash_cls",
                                     act_quant=True, dtype=torch.bfloat16),
        llama=dataclasses.replace(cfg.llama, act_quant=True, kv_quant=True,
                                  dtype=torch.bfloat16))
    return MiniGPT4Model(cfg, build_synthetic_params(cfg, device, seed=0), ByteTokenizer())


def attack_config(tmp_path, **run):
    """A tiny attack config over two written 64-px JPEGs."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    questions, annotations = [], []
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            img_dir / f"COCO_val2014_{5000 + i:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": 5000 + i, "question": "what?"})
        annotations.append({"question_id": i + 1, "image_id": 5000 + i,
                            "answers": [{"answer": ["cat", "dog"][i]}]})
    (tmp_path / "q.json").write_text(json.dumps({"questions": questions}))
    (tmp_path / "a.json").write_text(json.dumps({"annotations": annotations}))
    block = {"agent": "image_text_attack", "attack_backbones": ["vit_tiny", "rn_tiny"],
             "attack_steps": 3, "attack_epsilon": 0.03, "max_images": 2, "max_new_tokens": 4,
             "seq_len": 48, "noise_level": 0.5, "seed": 5, "output_dir": str(tmp_path / "out")}
    block.update(run)
    return Config({
        "model": {"arch": "minigpt4", "model_size": "tiny"},
        "datasets": {"evalvqav2": {
            "vis_processor": {"val": {"name": "blip2_image_val", "image_size": 224}},
            "build_info": {"images": {"storage": str(img_dir)},
                           "questions": {"val": [str(tmp_path / "q.json")]},
                           "annotations": {"val": [str(tmp_path / "a.json")]}},
        }},
        "run": block,
    })


def plain_kernels():
    return [mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain),
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain),
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_as_plain)]


@pytest.mark.gpu
def test_caption_at_batch_one_through_the_kernels_on_gpu(cuda, tmp_path, monkeypatch):
    model = kernel_victim(cuda)
    monkeypatch.setattr(TB.BaseAgent, "build_model", lambda self: model)
    agent = setup_agent(attack_config(tmp_path), device="cuda")
    depth = model.cfg.vit.depth
    rng = np.random.RandomState(1)
    for sigma in (0.0, 0.5):
        pixels = rng.rand(96, 96, 3).astype(np.float32)
        for fn in (FA.cls_split_attention_parts, Q.ln_quant_rows, Q.gelu_quant_rows):
            fn.launches = 0
        got = agent.caption(pixels, INSTRUCTION, (0, 3), sigma)
        assert (FA.cls_split_attention_parts.launches, Q.ln_quant_rows.launches,
                Q.gelu_quant_rows.launches) == (depth, 4 * depth, 2 * depth)
        patches = plain_kernels()
        for p in patches:
            p.start()
        try:
            want = agent.caption(pixels, INSTRUCTION, (0, 3), sigma)
        finally:
            for p in patches:
                p.stop()
        assert got == want


@pytest.mark.gpu
def test_pgd_step_on_gpu_matches_cpu(cuda):
    """A tiny ViT + ResNet ensemble: the loss gradient through a 448 -> 28
    and 448 -> 32 resize on the card within 1e-5 of the CPU's (relative to
    its largest entry) with the process-wide TF32 flags on; one PGD step
    moves at least 99.9 % of the pixels as on the CPU."""
    encs, encs_cpu = [], []
    for i, name in enumerate(("vit_tiny", "rn_tiny")):
        cfg, fn, init = TAG._BACKBONES[name]()
        params = init(1000 + i, cfg, "cpu")
        gpu_params = tree_to(params, cuda)
        apply = (lambda f, c: lambda p, x: f(p, c, x))(fn, cfg)
        encs.append(TA.SurrogateEncoder(name, apply, gpu_params, cfg.image_size))
        encs_cpu.append(TA.SurrogateEncoder(name, apply, params, cfg.image_size))
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(1, 448, 448, 3).astype(np.float32))
    t = torch.from_numpy(rng.rand(1, 448, 448, 3).astype(np.float32))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        results = []
        for es, dev in ((encs, cuda), (encs_cpu, torch.device("cpu"))):
            pbn = {e.name: e.params for e in es}
            tg = TA.embed_images(es, pbn, t.to(dev))
            xg = x.to(dev).requires_grad_(True)
            with TA.exact_f32():
                (grad,) = torch.autograd.grad(TA.ensemble_loss(es, xg, pbn, tg), xg)
            step = TA.make_pgd_attack(es, 8 / 255, 1 / 255, 1)(pbn, x.to(dev), tg)
            results.append((grad.cpu(), step.cpu()))
        assert torch.backends.cudnn.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    (g_gpu, s_gpu), (g_cpu, s_cpu) = results
    assert float((g_gpu - g_cpu).abs().max()) <= 1e-5 * float(g_cpu.abs().max())
    assert float((s_gpu == s_cpu).float().mean()) >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_pgd_graph_matches_the_eager_loop(cuda, b):
    """A tiny ViT + ResNet ensemble at 448 px, 6 steps: the pixels after
    the replayed step bit for bit the eager loop's, for two images in turn;
    one capture for the shape, none for the second image."""
    encs = []
    for i, name in enumerate(("vit_tiny", "rn_tiny")):
        cfg, fn, init = TAG._BACKBONES[name]()
        apply = (lambda f, c: lambda p, x: f(p, c, x))(fn, cfg)
        encs.append(TA.SurrogateEncoder(name, apply, tree_to(init(2000 + i, cfg, "cpu"), cuda),
                                        cfg.image_size))
    pbn = {e.name: e.params for e in encs}
    attack = TA.make_pgd_attack(encs, 8 / 255, 1 / 255, 6)
    rng = np.random.RandomState(3)
    for _ in range(2):
        x = torch.from_numpy(rng.rand(b, 448, 448, 3).astype(np.float32)).to(cuda)
        tg = TA.embed_images(encs, pbn, torch.from_numpy(
            rng.rand(b, 448, 448, 3).astype(np.float32)).to(cuda))
        want = attack(pbn, x, tg, cuda_graph=False)
        got = attack(pbn, x, tg)
        assert torch.equal(got, want)
        assert float((got - x).abs().max()) <= 8 / 255 + 1e-6
    assert attack.captures == 1


@pytest.mark.gpu
def test_attack_agent_runs_on_gpu(cuda, tmp_path, monkeypatch):
    """The agent on the card (kernel victim, tiny surrogates, sigma 0.5):
    rows within the budget, its files, one ViT forward a caption."""
    model = kernel_victim(cuda)
    monkeypatch.setattr(TB.BaseAgent, "build_model", lambda self: model)
    FA.cls_split_attention_parts.launches = 0
    summary = setup_agent(attack_config(tmp_path), device="cuda").run()
    assert summary["total"] == 4 and "ancova" in summary
    rows = [json.loads(line) for line in (tmp_path / "out" / "attack_results.jsonl")
            .read_text().splitlines()]
    assert all(0 < r["linf"] <= 0.03 + 1e-6 for r in rows)
    captions = 2 * (1 + 2)  # per image: the clean caption and one per backbone
    assert FA.cls_split_attention_parts.launches == captions * model.cfg.vit.depth
    assert (tmp_path / "out" / "attack_ancova.csv").exists()
