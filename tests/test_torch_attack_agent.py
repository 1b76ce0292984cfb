"""Port parity of the attack agent (``attack/agent.py``) on the CPU, against
the JAX package's ``image_text_attack`` on the same victim weights (the JAX
tiny model's, carried across by ``params_from_jax``): a caption at sigma 0,
the whole run at sigma 0 with no budget (``attack_epsilon: 0``, so the PGD
leaves every image as it is), the RGF query stage at sigma 0 and the CLIP
text scorer from an HF directory give the JAX agent's rows, files and
embeddings. Surrogate weights load from an HF directory, an OpenAI
checkpoint (plain or TorchScript) and ``eva_vit_g.pth`` behind the shape
guard. The port's own runs keep the budget, the sigma-independent transfer
stage and the launcher's files. Noise streams cannot equal JAX's
(``torch.Generator`` against ``jax.random``): ``caption_key`` streams are
held disjoint instead.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from certifiedgpt_tpu import registration as j_registration  # noqa: F401
from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.attack import clip as JC
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu_torch import launch
from certifiedgpt_tpu_torch import registration  # noqa: F401
from certifiedgpt_tpu_torch.agents import base as TB
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.attack import agent as TAG
from certifiedgpt_tpu_torch.attack import clip as TC
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models.convert import convert_eva_vit_state_dict
from certifiedgpt_tpu_torch.models.eva_vit import EvaViTConfig
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, config_from_block

from chip_smoke import clip_tokenizer_files
from test_torch_attack import openai_resnet_state_dict
from test_torch_checkpoints_gpu import eva_state_dict

TINY_BLOCK = {"arch": "minigpt4", "model_size": "tiny"}
INSTRUCTION = "<Img><ImageHere></Img> Describe this image."


@pytest.fixture(scope="module")
def attack_data(tmp_path_factory):
    """Three 32-px JPEGs with VQAv2-shaped JSONs (the JAX agent test's), and
    ``make(out, **run)``: a config dict for them (tiny model, 28-px images)."""
    root = tmp_path_factory.mktemp("attack")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    questions, annotations = [], []
    for i in range(3):
        image_id = 4000 + i
        arr = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"COCO_val2014_{image_id:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": image_id,
                          "question": f"what is {i}?"})
        annotations.append({"question_id": i + 1, "image_id": image_id,
                            "answers": [{"answer": ["cat", "dog", "fish"][i],
                                         "answer_confidence": "yes"}]})
    (root / "q.json").write_text(json.dumps({"questions": questions}))
    (root / "a.json").write_text(json.dumps({"annotations": annotations}))

    def make(out, **run_extra):
        run = {"agent": "image_text_attack", "attack_backbones": ["vit_tiny"],
               "attack_steps": 2, "attack_epsilon": 0.03, "rgf_queries": 0,
               "max_images": 2, "max_new_tokens": 3, "seq_len": 48, "noise_level": 0.0,
               "output_dir": str(root / "out" / out), "seed": 5}
        run.update(run_extra)
        return {
            "model": dict(TINY_BLOCK),
            "datasets": {"evalvqav2": {
                "vis_processor": {"val": {"name": "blip2_image_val", "image_size": 28}},
                "build_info": {
                    "images": {"storage": str(img_dir)},
                    "questions": {"val": [str(root / "q.json")]},
                    "annotations": {"val": [str(root / "a.json")]},
                },
            }},
            "run": run,
        }

    make.root = root
    return make


@pytest.fixture(scope="module")
def jax_tree():
    from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel

    return jax.tree.map(np.asarray, JModel.from_config(dict(TINY_BLOCK)).params)


@pytest.fixture()
def port_on_jax_weights(monkeypatch, jax_tree):
    """The port's agents build the victim from the JAX agents' weights."""
    ct = config_from_block(TINY_BLOCK)

    def build_model(self):
        return MiniGPT4Model(ct, params_from_jax(jax_tree, ct, "cpu"), ByteTokenizer())

    monkeypatch.setattr(TB.BaseAgent, "build_model", build_model)


def _run_both(cfg):
    """Run the JAX agent and the port's on ``cfg`` (output dirs apart);
    returns both output dirs."""
    out = cfg["run"]["output_dir"]
    jcfg = json.loads(json.dumps(cfg))
    jcfg["run"]["output_dir"] = out + "_jax"
    j_setup_agent(JConfig(jcfg)).run()
    setup_agent(Config(cfg), device="cpu").run()
    return out + "_jax", out


def _assert_same_files(jax_out, port_out):
    for name in ("attack_results.jsonl", "attack_summary.json", "attack_ancova.csv"):
        ref = open(os.path.join(jax_out, name)).read()
        assert open(os.path.join(port_out, name)).read() == ref, name


def test_caption_key_streams_are_disjoint():
    """The JAX test's streams: clean, adversarial and RGF namespaces over
    three images, with query counters past an arithmetic packing's base,
    at two sigmas; every seed is a distinct 64-bit int."""
    seen = {}
    streams = []
    for idx in range(3):
        streams.append((0, idx))
        for b in range(3):
            streams.append((1, idx, b))
            for s_idx in range(2):
                for q in range(1, 1002, 500):
                    streams.append((2, idx, s_idx, b, q))
    for sigma in (0.0, 0.5):
        for stream in streams:
            key = TAG.caption_key(7, stream, sigma)
            assert isinstance(key, int) and 0 <= key < 2 ** 64
            assert key not in seen, f"key collision: {stream}/{sigma} vs {seen[key]}"
            seen[key] = (stream, sigma)
    assert TAG.caption_key(7, (0, 1), 0.5) == TAG.caption_key(7, (0, 1), 0.5)
    assert TAG.caption_key(8, (0, 1), 0.5) != TAG.caption_key(7, (0, 1), 0.5)


def test_caption_matches_jax_at_sigma_zero(attack_data, port_on_jax_weights):
    """The same pixels (at the victim's 28 px, and 56 px resized down)
    give the JAX agent's caption at sigma 0."""
    cfg = attack_data("caption")
    jagent = j_setup_agent(JConfig(json.loads(json.dumps(cfg))))
    agent = setup_agent(Config(cfg), device="cpu")
    rng = np.random.RandomState(1)
    for size in (28, 56):
        pixels = rng.rand(size, size, 3).astype(np.float32)
        for stream in ((0, 0), (1, 2, 0)):
            ref = jagent.caption(pixels, INSTRUCTION, stream, 0.0)
            assert agent.caption(pixels, INSTRUCTION, stream, 0.0) == ref
    # sigma > 0 draws from the stream's generator: repeatable, stream-keyed
    noisy = [agent.caption(pixels, INSTRUCTION, s, 5.0) for s in ((0, 0), (0, 0), (0, 1))]
    assert noisy[0] == noisy[1]


def test_agent_matches_jax_with_no_budget(attack_data, port_on_jax_weights):
    """``attack_epsilon: 0``: PGD leaves each image as it is, whatever the
    surrogates' weights, so every row, the summary (with the ANCOVA over
    two backbones) and the CSV equal the JAX agent's at sigma 0."""
    cfg = attack_data("no_budget", attack_epsilon=0.0,
                      attack_backbones=["vit_tiny", "rn_tiny"])
    jax_out, port_out = _run_both(cfg)
    _assert_same_files(jax_out, port_out)
    rows = [json.loads(line) for line in open(os.path.join(port_out, "attack_results.jsonl"))]
    assert len(rows) == 4 and all(r["linf"] == 0.0 for r in rows)
    assert "ancova" in json.load(open(os.path.join(port_out, "attack_summary.json")))


def test_rgf_stage_matches_jax_at_sigma_zero(attack_data, port_on_jax_weights, monkeypatch):
    """``rgf_queries`` 2, ``rgf_iters`` 1 from the clean image (no PGD
    steps): the query stage's captions, hence its directions and step, and
    the rows equal the JAX agent's; each (image, backbone) runs 1 + 2
    query captions, the clean one and the adversarial one."""
    cfg = attack_data("rgf", attack_steps=0, attack_epsilon=8 / 255, rgf_queries=2,
                      rgf_iters=1, max_images=1)
    calls = []
    caption = TAG.AttackAgent.caption

    def counted(self, pixels, instruction, stream, sigma=None):
        calls.append(tuple(stream))
        return caption(self, pixels, instruction, stream, sigma)

    monkeypatch.setattr(TAG.AttackAgent, "caption", counted)
    jax_out, port_out = _run_both(cfg)
    _assert_same_files(jax_out, port_out)
    assert calls == [(0, 0), (2, 0, 0, 0, 1), (2, 0, 0, 0, 2), (2, 0, 0, 0, 3), (1, 0, 0)]


def test_agent_end_to_end_with_the_jax_tests_knobs(attack_data):
    cfg = attack_data("e2e", attack_backbones=["vit_tiny", "rn_tiny", "blip2_vit_tiny"],
                      attack_steps=3)
    summary = setup_agent(Config(cfg), device="cpu").run()
    assert summary["total"] == 6  # 2 images x 3 backbones
    assert set(summary["success_rate_per_backbone"]) == {"vit_tiny", "rn_tiny",
                                                         "blip2_vit_tiny"}
    assert "ancova" in summary
    out = attack_data.root / "out" / "e2e"
    rows = [json.loads(line) for line in (out / "attack_results.jsonl").read_text().splitlines()]
    assert len(rows) == 6
    assert all(r["linf"] <= 0.03 + 1e-5 for r in rows)
    # three steps of 1/255 moved the pixels, at most three steps' worth
    assert any(r["linf"] > 0 for r in rows) and all(r["linf"] <= 3 / 255 + 1e-6 for r in rows)
    with open(out / "attack_ancova.csv") as handle:
        assert len(list(csv.DictReader(handle))) == 6


def test_agent_sigma_grid(attack_data):
    """One transfer attack per (image, backbone), scored at every sigma of
    the grid: linf of each (image, backbone) does not depend on sigma."""
    cfg = attack_data("grid", sigma_grid=[0.0, 0.5])
    summary = setup_agent(Config(cfg), device="cpu").run()
    assert summary["total"] == 4 and summary["sigma_grid"] == [0.0, 0.5]
    assert set(summary["success_rate_grid"]["vit_tiny"]) == {"0.0", "0.5"}
    rows = [json.loads(line) for line in
            (attack_data.root / "out" / "grid" / "attack_results.jsonl").read_text().splitlines()]
    assert sorted({r["sigma"] for r in rows}) == [0.0, 0.5]
    by_img = {}
    for r in rows:
        by_img.setdefault(r["index"], set()).add(r["linf"])
    assert all(len(v) == 1 for v in by_img.values())


def write_tiny_clip_dir(path, text_layers=2, patch=14):
    """A tiny HF CLIP directory (``save_pretrained``: ``model.safetensors``
    and ``config.json``, its text block cut to the fields that differ from
    CLIP's defaults) with the synthesized tokenizer."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    path.mkdir()
    vocab = clip_tokenizer_files(path)
    v = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, image_size=28, patch_size=patch,
                         projection_dim=16, hidden_act="quick_gelu")
    t = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=text_layers,
                       num_attention_heads=4, max_position_embeddings=16, vocab_size=vocab,
                       projection_dim=16, hidden_act="quick_gelu",
                       bos_token_id=vocab - 2, eos_token_id=vocab - 1)
    torch.manual_seed(0)
    CLIPModel(CLIPConfig(text_config=t.to_dict(), vision_config=v.to_dict(),
                         projection_dim=16)).save_pretrained(str(path))
    conf = json.loads((path / "config.json").read_text())
    defaults = CLIPTextConfig().to_dict()
    conf["text_config"] = {k: val for k, val in conf["text_config"].items()
                           if defaults.get(k) != val}
    (path / "config.json").write_text(json.dumps(conf))
    return path


def test_text_encoder_from_hf_dir_matches_jax(attack_data, port_on_jax_weights, tmp_path):
    clip_dir = write_tiny_clip_dir(tmp_path / "clip")
    cfg = attack_data("text", clip_model=str(clip_dir))
    assert TAG.hf_text_config(str(clip_dir)) == TC.ClipTextConfig(
        vocab_size=514, max_len=16, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, projection_dim=16)
    jagent = j_setup_agent(JConfig(json.loads(json.dumps(cfg))))
    agent = setup_agent(Config(cfg), device="cpu")
    assert not isinstance(agent.text_encoder, TAG._HashTextEncoder)
    texts = ["a cat", "two dogs sit on a red mat!", "", "cat"]
    got = agent.text_encoder(texts)
    np.testing.assert_allclose(got, jagent.text_encoder(texts), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("patch,loads", [(14, True), (7, False)])
def test_vit_surrogate_loads_from_hf_dir(attack_data, port_on_jax_weights, tmp_path,
                                         patch, loads):
    """``clip_model_vit_tiny``: the directory's vision tower (converted as
    the JAX agent converts it, with a 12-layer text tower) replaces the
    seeded weights, the JAX agent's leaf for leaf; another patch size fails
    the shape guard and keeps the seeded weights."""
    clip_dir = write_tiny_clip_dir(tmp_path / "clip", text_layers=12, patch=patch)
    cfg = attack_data("vitdir", clip_model_vit_tiny=str(clip_dir))
    agent = setup_agent(Config(cfg), device="cpu")
    seeded = TC.init_clip_vit(1000, TC.ClipViTConfig.tiny(), "cpu")
    leaves = jax.tree.leaves(agent.encoders[0].params)
    if not loads:
        assert all(torch.equal(a, b) for a, b in zip(leaves, jax.tree.leaves(seeded)))
        return
    jagent = j_setup_agent(JConfig(json.loads(json.dumps(cfg))))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jagent.encoders[0].params))
    assert len(ref) == len(leaves)
    for a, b in zip(ref, leaves):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("torchscript", [False, True])
def test_rn_surrogate_loads_an_openai_checkpoint(attack_data, port_on_jax_weights, tmp_path,
                                                 torchscript):
    """``clip_model_rn_tiny``: a ``torch.save`` state dict or a TorchScript
    archive (the released ``RN50.pt`` format) in the OpenAI layout."""
    rcfg = TC.ClipResNetConfig.tiny()
    sd = openai_resnet_state_dict(rcfg, np.random.RandomState(2))
    path = tmp_path / "rn.pt"
    if torchscript:
        root = torch.nn.Module()
        for key, value in sd.items():
            mod = root
            for part in key.split(".")[:-1]:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_buffer(key.split(".")[-1], value)
        torch.jit.script(root).save(str(path))
    else:
        torch.save(sd, path)
    cfg = attack_data("rnckpt", attack_backbones=["rn_tiny"], clip_model_rn_tiny=str(path))
    agent = setup_agent(Config(cfg), device="cpu")
    want = TC.convert_openai_clip_resnet(sd, rcfg)
    got = agent.encoders[0].params
    assert TAG.AttackAgent._shapes_match(want, got)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)))


def test_blip2_surrogate_loads_eva_vit_g(attack_data, port_on_jax_weights, tmp_path):
    """``blip2_vit_tiny`` reads the model block's ``eva_vit_g_pth`` (the
    position table resampled to the surrogate's grid) in f32, no int8."""
    sd = eva_state_dict(np.random.RandomState(3))
    path = tmp_path / "eva_vit_g.pth"
    torch.save(sd, path)
    cfg = attack_data("eva", attack_backbones=["blip2_vit_tiny"])
    cfg["model"]["eva_vit_g_pth"] = str(path)
    agent = setup_agent(Config(cfg), device="cpu")
    want = convert_eva_vit_state_dict(sd, EvaViTConfig.tiny())
    got = agent.encoders[0].params
    assert "kernel" in got["layers"]["qkv"] and got["layers"]["qkv"]["kernel"].dtype == (
        torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)))


def test_launch_attack_on_the_cpu(attack_data, tmp_path, monkeypatch):
    """``launch.main(["attack", ...])`` routes to ``image_text_attack`` and
    writes its three files; without ``--device cpu`` and without CUDA it
    stops."""
    cfg = attack_data("launch", max_images=1)
    del cfg["run"]["agent"]
    path = tmp_path / "attack.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    summary = launch.main(["attack", "--config-path", str(path), "--device", "cpu"])
    out = attack_data.root / "out" / "launch"
    assert summary == json.load(open(out / "attack_summary.json"))
    assert summary["total"] == 1
    assert (out / "attack_results.jsonl").exists() and (out / "attack_ancova.csv").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launch.main(["attack", "--config-path", str(path)])


def test_unknown_backbone_raises(attack_data, port_on_jax_weights):
    with pytest.raises(KeyError, match="vit_b99"):
        setup_agent(Config(attack_data("unknown", attack_backbones=["vit_b99"])), device="cpu")
    assert set(TAG._BACKBONES) == {"vit_b32", "vit_b16", "vit_l14", "rn50", "rn101",
                                   "blip2_vit", "blip2_vit_tiny", "vit_tiny", "rn_tiny"}
    cfg, _, _ = TAG._BACKBONES["blip2_vit"]()
    assert (cfg.img_size, cfg.dtype, cfg.attn_impl, cfg.act_quant) == (
        224, torch.float32, "xla", False)
    assert JC.ClipViTConfig.l14().projection_dim == TAG._BACKBONES["vit_l14"]()[0].projection_dim
