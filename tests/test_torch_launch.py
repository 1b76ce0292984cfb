"""Port parity of the launcher slice, on the CPU: the config, the dataset
path and the checkpoint reader give the JAX package's results; the certify
and predict agents write the JAX agents' rows and summaries at sigma = 0
on the same weights (a sigma sweep and the global vocabulary included);
``model.vqa_finetuned`` replaces the projection the forward reads; the
knobs the port does not have yet are refused; and the CLI runs on the CPU
only when asked to."""

import glob
import json
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from certifiedgpt_tpu import registration as j_registration  # noqa: F401
from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.common.checkpoint import save_checkpoint as j_save_checkpoint
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu.common.registry import registry as j_registry
from certifiedgpt_tpu.data import processors as JP
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.smoothing import smoothing as JS
from certifiedgpt_tpu.smoothing.classifier import AnswerVocabulary as JVocab
from certifiedgpt_tpu_torch import launch
from certifiedgpt_tpu_torch.agents import base as TB
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.agents.certify import certify_item
from certifiedgpt_tpu_torch.common.checkpoint import load_checkpoint
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.data import processors as TP
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, config_from_block
from certifiedgpt_tpu_torch.smoothing import smoothing as TS
from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CERTIFY_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "certify_configs", "*.yaml")))
TINY_BLOCK = {"arch": "minigpt4", "model_size": "tiny"}
# answers of the six questions: the global vocabulary ranks them by count
ANSWERS = [["cat"] * 6 + ["dog"] * 4, ["two"] * 7 + ["2"] * 3, ["yes"] * 10,
           ["dog"] * 5 + ["cat"] * 5, ["red"] * 9 + ["Red."], ["no"] * 6 + ["yes"] * 4]
TIMING_KEYS = {"seconds", "mean_seconds_per_image"}


@pytest.fixture(scope="module")
def vqa(tmp_path_factory):
    """Six 32-px JPEGs with VQAv2-shaped question and annotation JSONs, and
    ``make(agent, out, **run)``: a config dict for them (tiny model, 28-px
    images, the evalvqav2 dataset)."""
    root = tmp_path_factory.mktemp("vqa")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    questions, annotations = [], []
    for i, answers in enumerate(ANSWERS):
        image_id = 3000 + i
        arr = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
        for split in ("val", "train"):
            Image.fromarray(arr).save(img_dir / f"COCO_{split}2014_{image_id:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": image_id,
                          "question": f"what is {i}?"})
        annotations.append({
            "question_id": i + 1, "image_id": image_id,
            "question_type": "what is", "answer_type": "other",
            "answers": [{"answer": a, "answer_confidence": ("yes", "maybe", "no")[j % 3],
                         "answer_id": j + 1} for j, a in enumerate(answers)],
        })
    (root / "q.json").write_text(json.dumps({"questions": questions}))
    (root / "a.json").write_text(json.dumps({"annotations": annotations}))

    def make(agent, out, **run_extra):
        run = {"agent": agent, "seq_len": 48, "max_new_tokens": 4, "noise_level": 0.0,
               "certify_n0": 8, "certify_n": 16, "certify_alpha": 0.05, "predict_n": 16,
               "mc_batch": 8, "max_images": 2, "seed": 3,
               "output_dir": str(root / "out" / out)}
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
    """The tiny model's parameters as the JAX agents build them."""
    from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel

    return jax.tree.map(np.asarray, JModel.from_config(dict(TINY_BLOCK)).params)


@pytest.fixture()
def port_on_jax_weights(monkeypatch, jax_tree):
    """The port's agents build the model from the JAX agents' weights."""
    ct = config_from_block(TINY_BLOCK)

    def build_model(self):
        return MiniGPT4Model(ct, params_from_jax(jax_tree, ct, "cpu"), ByteTokenizer())

    monkeypatch.setattr(TB.BaseAgent, "build_model", build_model)


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
            for line in open(path).read().splitlines()]


def _summary(path):
    return {k: v for k, v in json.load(open(path)).items() if k not in TIMING_KEYS}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f != "certified.log")


@pytest.mark.parametrize("agent,run_extra,mode", [
    ("image_text_certify", {}, "certify"),
    ("image_text_predict", {"early_abstain": True}, "predict"),
    ("image_text_certify", {"sigma_grid": [0.0, 0.5]}, "certify"),
    ("image_text_certify", {"vocab_mode": "global", "vocab_top_k": 4, "max_images": 3}, "certify"),
], ids=["certify", "predict", "sigma_grid", "vocab_global"])
def test_agent_rows_match_jax_at_sigma_zero(vqa, port_on_jax_weights, agent, run_extra, mode):
    """Same weights, sigma 0: every row field but ``seconds`` and the
    summary but its timing key equal the JAX agent's; a sweep writes the
    same files with the same keys, and its sigma 0 cell the same rows."""
    name = f"{mode}-{'-'.join(map(str, run_extra))}"
    j_agent = j_setup_agent(JConfig(vqa(agent, f"jax-{name}", **run_extra)))
    j_result = j_agent.run()
    j_agent.finalize()
    t_agent = setup_agent(Config(vqa(agent, f"torch-{name}", **run_extra)), device="cpu")
    t_result = t_agent.run()
    t_agent.finalize()
    j_out, t_out = (vqa.root / "out" / f"{side}-{name}" for side in ("jax", "torch"))
    assert _files(t_out) == _files(j_out)
    assert json.load(open(t_out / "loss_history.json")) == {"train": [], "val": []}
    if "sigma_grid" in run_extra:
        assert set(t_result["sweep"]) == set(j_result["sweep"]) == {"0.0", "0.5"}
        for sigma in ("0.0", "0.5"):
            j_rows = _rows(j_out / f"sigma_{sigma}" / "certify_results.jsonl")
            t_rows = _rows(t_out / f"sigma_{sigma}" / "certify_results.jsonl")
            assert [set(r) for r in t_rows] == [set(r) for r in j_rows]
            assert set(t_result["sweep"][sigma]) == set(j_result["sweep"][sigma])
        j_out, t_out = j_out / "sigma_0.0", t_out / "sigma_0.0"
    else:
        assert {k: v for k, v in t_result.items() if k not in TIMING_KEYS} == _summary(
            j_out / f"{mode}_summary.json")
    assert _rows(t_out / f"{mode}_results.jsonl") == _rows(j_out / f"{mode}_results.jsonl")
    assert _summary(t_out / f"{mode}_summary.json") == _summary(j_out / f"{mode}_summary.json")
    if run_extra.get("vocab_mode") == "global":
        assert t_agent._global_vocab.labels == j_agent._global_vocab.labels
        assert t_agent._global_vocab.num_classes == 5


def test_agent_rows_match_certify_item(vqa):
    """At sigma 0.25 with early stopping, the agent's rows are
    ``certify_item``'s on the same items."""
    run_extra = {"noise_level": 0.25, "certify_n0": 8, "certify_n": 40, "early_abstain": True,
                 "early_stop_radius": 0.05, "early_exit": True, "max_images": 3}
    config = Config(vqa("image_text_certify", "torch-vs-item", **run_extra))
    agent = setup_agent(config, device="cpu")
    agent.run()
    rows = _rows(vqa.root / "out" / "torch-vs-item" / "certify_results.jsonl")
    dataset = agent.eval_dataset()
    want = []
    for idx in range(3):
        item = dataset[idx]
        row = certify_item(agent.model, item["image"], item["instruction_input"],
                           item["gt_answers"], config.run, index=idx,
                           question_id=item["question_id"])
        want.append({k: v for k, v in row.items() if k not in TIMING_KEYS})
    assert rows == want
    assert any(r["draws"] < 48 for r in rows)  # the early stop fired


def _env_names(path):
    return sorted(set(re.findall(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)", open(path).read())))


@pytest.mark.parametrize("with_env", [False, True], ids=["defaults", "env"])
@pytest.mark.parametrize("path", CERTIFY_CONFIGS, ids=os.path.basename)
def test_config_resolves_shipped_yaml_as_jax(path, with_env, monkeypatch):
    names = _env_names(path)
    assert names
    for name in names:
        if with_env:
            monkeypatch.setenv(name, f"/elsewhere/{name.lower()}")
        else:
            monkeypatch.delenv(name, raising=False)
    got, want = Config(path), JConfig(path)
    assert got.to_dict() == want.to_dict()
    assert (got.arch, got.evaluate_only) == (want.arch, want.evaluate_only)
    assert got.run.output_dir == want.run.output_dir
    assert got.model["vqa_finetuned"] == want.model.get("vqa_finetuned")
    assert registry.get("configuration") is got


def test_config_reads_env_when_a_value_is_read(monkeypatch):
    monkeypatch.delenv("CGPT_TEST_DIR", raising=False)
    config = Config({"run": {"output_dir": "${env:CGPT_TEST_DIR,out/default}"}})
    assert config.run.output_dir == "out/default"
    monkeypatch.setenv("CGPT_TEST_DIR", "/tmp/x")
    assert config.run.get("output_dir") == "/tmp/x"
    with pytest.raises(KeyError, match="unset"):
        Config({"a": "${env:CGPT_TEST_UNSET_VAR}"}).to_dict()


def test_registries_are_separate():
    from certifiedgpt_tpu.agents.certify import CertifyAgent as JCertifyAgent
    from certifiedgpt_tpu_torch.agents.certify import CertifyAgent

    assert registry.get_agent_class("image_text_certify") is CertifyAgent
    assert j_registry.get_agent_class("image_text_certify") is JCertifyAgent
    assert registry.get_model_class("minigpt4") is MiniGPT4Model
    assert registry.list_builders() == ["cc_sbu", "evalvqav2", "testvqav2", "vqav2"]
    assert registry.list_processors() == ["blip2_image_train", "blip2_image_val",
                                          "blip_caption"]


def test_image_processor_is_bit_identical_to_jax(tmp_path):
    rng = np.random.RandomState(1)
    path = tmp_path / "photo.jpg"
    Image.fromarray(rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)).save(path)
    for name, size in (("blip2_image_val", 448), ("blip2_image_train", 224)):
        t = registry.get_processor_class(name).from_config({"image_size": size})
        j = j_registry.get_processor_class(name).from_config({"image_size": size})
        got = t(Image.open(path).convert("RGB"))
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, j(Image.open(path).convert("RGB")))
    arr = rng.rand(20, 30, 3).astype(np.float32)
    np.testing.assert_array_equal(TP.Blip2ImageEvalProcessor(28)(arr),
                                  JP.Blip2ImageEvalProcessor(28)(arr))
    caption = TP.BlipCaptionProcessor.from_config({"prompt": "a ", "max_words": 3})
    j_caption = JP.BlipCaptionProcessor.from_config({"prompt": "a ", "max_words": 3})
    for text in ("A Cat, on (the) mat!", "  two   dogs.\n", "one"):
        assert caption(text) == j_caption(text)


@pytest.mark.parametrize("builder,split", [("evalvqav2", "val"), ("vqav2", "train"),
                                           ("vqav2", "val"), ("testvqav2", "test")])
def test_dataset_items_are_bit_identical_to_jax(vqa, builder, split):
    block = vqa("image_text_certify", "unused")["datasets"]["evalvqav2"]
    info = block["build_info"]
    cfg = {
        "vis_processor": {split: {"name": "blip2_image_val", "image_size": 28}},
        "text_processor": {split: {"name": "blip_caption"}} if builder == "vqav2" else {},
        "build_info": {
            "images": info["images"],
            "questions": {split: info["questions"]["val"]},
            "annotations": {} if split == "test" else {split: info["annotations"]["val"]},
        },
    }
    if split == "test":  # test2015 file names
        for f in os.listdir(info["images"]["storage"]):
            if f.startswith("COCO_val2014_"):
                src = os.path.join(info["images"]["storage"], f)
                dst = src.replace("COCO_val2014_", "COCO_test2015_")
                if not os.path.exists(dst):
                    os.link(src, dst)
    got = registry.get_builder_class(builder)(cfg).build_datasets()[split]
    want = j_registry.get_builder_class(builder)(cfg).build_datasets()[split]
    assert len(got) == len(want) == len(ANSWERS)
    for idx in range(len(got)):
        a, b = got[idx], want[idx]
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["image"], b["image"])
        assert {k: v for k, v in a.items() if k != "image"} == {
            k: v for k, v in b.items() if k != "image"}
    if builder == "evalvqav2":
        assert got[0]["gt_answers"] == ANSWERS[0]
        assert got.collater([got[0], got[1]])["image"].shape == (2, 28, 28, 3)


def test_cc_sbu_items_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    anns = []
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (40, 30, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.jpg")
        anns.append({"image_id": str(i), "caption": f"A long caption, number {i}."})
    (tmp_path / "filter_cap.json").write_text(json.dumps({"annotations": anns}))
    (tmp_path / "prompts.txt").write_text("<Img><ImageHere></Img> Describe.\nno image\n"
                                          "<Img><ImageHere></Img> Tell me.\n")
    cfg = {"vis_processor": {"train": {"name": "blip2_image_train", "image_size": 28}},
           "build_info": {"images": {"storage": str(tmp_path)},
                          "annotations": {"train": [str(tmp_path / "filter_cap.json")]},
                          "prompt_path": str(tmp_path / "prompts.txt"),
                          "prompt_template": "[INST] {} [/INST]"}}
    got = registry.get_builder_class("cc_sbu")(cfg).build_datasets()["train"]
    want = j_registry.get_builder_class("cc_sbu")(cfg).build_datasets()["train"]
    assert got.prompts == want.prompts and len(got.prompts) == 2
    for idx in range(3):
        np.testing.assert_array_equal(got[idx]["image"], want[idx]["image"])
        assert {k: v for k, v in got[idx].items() if k != "image"} == {
            k: v for k, v in want[idx].items() if k != "image"}


def _write_finetuned(path, seed=5):
    """A JAX-written llama_proj checkpoint, other values than the init."""
    rng = np.random.RandomState(seed)
    cfg = JM.MiniGPT4Config.tiny()
    trainable = {"llama_proj": {
        "kernel": jnp.asarray(rng.randn(cfg.qformer.hidden_size, cfg.llama.hidden_size)
                              .astype(np.float32) * 0.3),
        "bias": jnp.asarray(rng.randn(cfg.llama.hidden_size).astype(np.float32)),
    }}
    j_save_checkpoint(str(path), trainable, None, {"epoch": 3})
    return jax.tree.map(np.asarray, trainable)


def test_load_checkpoint_reads_the_jax_format(tmp_path):
    path = tmp_path / "ckpt.npz"
    want = _write_finetuned(path)
    template = {"llama_proj": {"kernel": torch.zeros(want["llama_proj"]["kernel"].shape),
                               "bias": torch.zeros(want["llama_proj"]["bias"].shape,
                                                   dtype=torch.bfloat16)}}
    got, meta = load_checkpoint(str(path), template)
    assert meta == {"epoch": 3}
    assert got["llama_proj"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(got["llama_proj"]["kernel"].numpy(),
                                  want["llama_proj"]["kernel"])
    assert got["llama_proj"]["bias"].dtype == torch.bfloat16
    assert torch.equal(got["llama_proj"]["bias"],
                       torch.tensor(want["llama_proj"]["bias"]).to(torch.bfloat16))
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_checkpoint(str(path), {"llama_proj": {"kernel": torch.zeros(2, 2),
                                                   "bias": template["llama_proj"]["bias"]}})
    with pytest.raises(KeyError, match="model:llama_proj/scale"):
        load_checkpoint(str(path), {"llama_proj": {"scale": torch.zeros(1)}})


@pytest.mark.parametrize("use_cache", [False, True], ids=["direct", "staged"])
def test_vqa_finetuned_replaces_the_projection(vqa, port_on_jax_weights, tmp_path,
                                               monkeypatch, use_cache):
    """The port's agent reads ``model.vqa_finetuned`` (a JAX-written
    ``.npz``) into the module the forward reads, so ``encode_img`` gives the
    JAX agent's output, not the unfinetuned one."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    path = tmp_path / "finetuned.npz"
    want = _write_finetuned(path)
    cfg = vqa("image_text_certify", f"finetuned-{use_cache}")
    cfg["model"]["vqa_finetuned"] = str(path)
    j_agent = j_setup_agent(JConfig(cfg))
    cfg["run"]["use_cache"] = use_cache
    agent = setup_agent(Config(cfg), device="cpu")
    proj = agent.model.params["llama_proj"]
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(proj[key].numpy(), want["llama_proj"][key])
        np.testing.assert_array_equal(np.asarray(j_agent.model.params["llama_proj"][key]),
                                      want["llama_proj"][key])
    assert len(os.listdir(tmp_path / "tmp")) == (2 if use_cache else 0)  # npz + meta

    images = np.random.RandomState(0).randn(2, 28, 28, 3).astype(np.float32)
    got = TM.encode_img(agent.model.params, agent.model.cfg, torch.from_numpy(images))
    ref = np.asarray(JM.encode_img(j_agent.model.params, j_agent.model.cfg, jnp.asarray(images)))
    base = setup_agent(Config(vqa("image_text_certify", "unfinetuned")), device="cpu")
    before = TM.encode_img(base.model.params, base.model.cfg, torch.from_numpy(images))
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32), rtol=1e-4, atol=1e-4)
    assert float((got.float() - before.float()).abs().max()) > 0.1


def test_missing_vqa_finetuned_raises(vqa, tmp_path):
    cfg = vqa("image_text_predict", "missing")
    cfg["model"]["vqa_finetuned"] = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError):
        setup_agent(Config(cfg), device="cpu")


def _rows_without_timing(path):
    return [{k: v for k, v in row.items() if k not in TIMING_KEYS} for row in _rows(path)]


def _certify_on_ranks(vqa, tmp_path, out, n, **run):
    """``launch.main`` certify with ``run.distributed`` on ``n`` gloo CPU
    ranks; returns rank 0's rows, and the same config's rows in this
    process (one rank, no process group)."""
    from certifiedgpt_tpu_torch.parallel.processes import run_ranks

    cfg = vqa("image_text_certify", out, distributed=True, **run)
    path = tmp_path / f"{out}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    run_ranks(n, f"""
from certifiedgpt_tpu_torch import launch
launch.main(["certify", "--config-path", {str(path)!r}, "--device", "cpu"])
""", str(tmp_path), timeout=240)
    got = _rows_without_timing(vqa.root / "out" / out / "certify_results.jsonl")
    one = dict(cfg["run"], distributed=False, model_parallel=1, dcn_parallel=0,
               pipeline_parallel=1,
               output_dir=str(vqa.root / "out" / f"{out}-one"))
    agent = setup_agent(Config(dict(cfg, run=one)), device="cpu")
    try:
        agent.run()
    finally:
        agent.finalize()
    return got, _rows_without_timing(vqa.root / "out" / f"{out}-one" / "certify_results.jsonl")


@pytest.mark.parametrize("knob,value,item", [
    ("num_beams", 2, "item 13"), ("enable_profile", True, "item 16"),
    ("model_parallel", 2, "item 16"), ("pipeline_parallel", 2, "item 16"),
    ("dcn_parallel", 2, "item 16"),
])
def test_unported_knobs_are_refused(vqa, tmp_path, knob, value, item):
    """The knobs of ROADMAP items 13 and 16 are ported: ``num_beams`` builds
    the eval agent with beam search on; ``enable_profile`` writes a trace of
    the certify run (a Chrome trace JSON); ``model_parallel`` 2 (the decoder
    tensor-parallel) and ``dcn_parallel`` 2 (the Monte-Carlo batch over two
    ranks) certify on two gloo ranks with rows equal to one process's. So
    does ``pipeline_parallel`` 2 (item 17): each stage keeps the whole
    decoder, runs it sequentially and takes its data ranks' share of the
    batch (one each here)."""
    if knob == "num_beams":
        agent = setup_agent(Config(vqa("image_text_eval", "beams", **{knob: value})),
                            device="cpu")
        assert agent.num_beams == value
        return
    if knob == "enable_profile":
        logdir = tmp_path / "trace"
        agent = setup_agent(Config(vqa("image_text_certify", "profiled", enable_profile=True,
                                       profile_step=1, duration_ms=60000,
                                       profile_logdir=str(logdir))), device="cpu")
        try:
            agent.run()
        finally:
            agent.finalize()  # the window outlives the run: finalize writes it
        traces = list(logdir.glob("trace_rank0_epoch0_step1.json"))
        assert len(traces) == 1
        assert json.loads(traces[0].read_text())["traceEvents"]
        return
    got, want = _certify_on_ranks(vqa, tmp_path, f"ranks-{knob}", 2, **{knob: value})
    assert got == want and len(got) == 2


@pytest.mark.parametrize("mode,item", [("train", 16), ("attack", 15)])
def test_launcher_refuses_unported_modes(mode, item, vqa, tmp_path):
    """``train`` runs the shipped VQAv2 YAML with ``pipeline_parallel: 2``
    (item 17, the GPipe schedule) into the mesh, which at world size 1
    raises the JAX ``make_mesh``'s message before a model is built (two
    ranks train: tests/test_torch_pipeline.py). ``attack``
    (item 15) is ported: it routes to ``image_text_attack``, which writes its
    rows, summary and ANCOVA CSV."""
    if mode == "attack":
        cfg = vqa("", "routed-attack", attack_backbones=["vit_tiny"], attack_steps=1,
                  max_images=1)
        del cfg["run"]["agent"]
        path = tmp_path / "attack.yaml"
        path.write_text(json.dumps(cfg))  # JSON is YAML
        summary = launch.main([mode, "--config-path", str(path), "--device", "cpu"])
        out = vqa.root / "out" / "routed-attack"
        assert registry.get("configuration").run.agent == "image_text_attack"
        assert summary == json.load(open(out / "attack_summary.json"))
        assert summary["total"] == 1 and len(_rows(out / "attack_results.jsonl")) == 1
        assert (out / "attack_ancova.csv").exists()
        return
    cfg = Config(os.path.join(REPO, "configs", "train_configs",
                              "vqav2_finetuning_noise_0.5.yaml")).to_dict()
    cfg["run"].update(pipeline_parallel=2, output_dir=str(tmp_path / "out"))
    path = tmp_path / "train.yaml"
    path.write_text(json.dumps(cfg))
    built = []
    with mock.patch.object(TB.BaseAgent, "build_model", lambda self: built.append(self)), \
            pytest.raises(ValueError,
                          match="^1 devices do not divide into pipeline_parallel=2 stages$"):
        launch.main([mode, "--config-path", str(path), "--device", "cpu"])
    assert not built


def test_launcher_routes_eval_to_image_text_eval(vqa, tmp_path):
    cfg = vqa("", "routed-eval", batch_size=4)
    del cfg["run"]["agent"]
    path = tmp_path / "eval.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    summary = launch.main(["eval", "--config-path", str(path), "--device", "cpu"])
    out = vqa.root / "out" / "routed-eval"
    assert registry.get("mode") == "eval"
    assert registry.get("configuration").run.agent == "image_text_eval"
    assert summary["num_questions"] == len(ANSWERS)
    saved = json.load(open(out / "eval_results.json"))
    assert saved["summary"] == summary and len(saved["predictions"]) == len(ANSWERS)


def test_launcher_routes_predict_and_refuses_distributed(vqa, tmp_path):
    """``smoothing_predict`` routes to the predict agent. ``run.distributed``
    without the ``env://`` variables of ``torch.distributed.run`` raises
    (no single-process fallback); in a process group the caller made (one
    gloo rank, joined through a file) the same run gives the same rows,
    and the group is left to its maker."""
    import torch.distributed as dist

    cfg = vqa("", "routed")
    del cfg["run"]["agent"]
    path = tmp_path / "predict.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    summary = launch.main(["smoothing_predict", "--config-path", str(path), "--device", "cpu"])
    out = vqa.root / "out" / "routed"
    assert summary["total"] == 2 and summary["n"] == 16
    assert len(_rows(out / "predict_results.jsonl")) == 2
    assert (out / "certified.log").exists() and registry.get("mode") == "smoothing_predict"
    plain = _rows_without_timing(out / "predict_results.jsonl")
    cfg["run"].update(distributed=True, output_dir=str(vqa.root / "out" / "routed-dist"))
    path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", env)
        with pytest.raises(RuntimeError, match="env://"):
            launch.main(["smoothing_predict", "--config-path", str(path), "--device", "cpu"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        summary = launch.main(["smoothing_predict", "--config-path", str(path),
                               "--device", "cpu"])
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert summary["total"] == 2
    assert _rows_without_timing(vqa.root / "out" / "routed-dist" / "predict_results.jsonl") \
        == plain


@pytest.mark.parametrize("alpha", [0.001, 0.05, 0.3])
def test_helpers_match_jax(alpha):
    for n in (0, 1, 10, 100, 1000):
        for k in sorted({0, 1, n // 3, n // 2, n - 1, n} - {-1}):
            if k > n:
                continue
            assert TS.clopper_pearson_upper(k, n, alpha) == JS.clopper_pearson_upper(k, n, alpha)
            lo = TS.clopper_pearson_lower(k, n, alpha)
            up = TS.clopper_pearson_upper(k, n, alpha)
            assert 0.0 <= lo <= up <= 1.0
            if 0 < k < n:
                r = TS.certified_radius_two_class(0.5, up, 1.0 - up)
                assert r == JS.certified_radius_two_class(0.5, up, 1.0 - up)
    assert TS.certified_radius_two_class(0.25, 0.9, 0.05) == JS.certified_radius_two_class(
        0.25, 0.9, 0.05)


def test_from_annotations_matches_jax(vqa):
    anns = json.load(open(vqa.root / "a.json"))["annotations"]
    for top_k in (1, 3, 3000):
        got = AnswerVocabulary.from_annotations(anns, top_k)
        want = JVocab.from_annotations(anns, top_k)
        assert got.labels == want.labels and got.num_classes == want.num_classes


def _cli(args, cwd, timeout=300, **env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-m", "certifiedgpt_tpu_torch.launch", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout, env=env)


def test_cli_certify_on_the_cpu(vqa, tmp_path):
    """``--device cpu`` runs a certify config through the CLI; without
    ``--device`` it runs on the card, so with no CUDA it stops non-zero."""
    path = tmp_path / "certify.yaml"
    path.write_text(json.dumps(vqa("image_text_certify", "cli", noise_level=0.25)))
    proc = _cli(["certify", "--config-path", str(path), "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = vqa.root / "out" / "cli"
    rows = _rows(out / "certify_results.jsonl")
    assert len(rows) == 2 and all(r["sigma"] == 0.25 for r in rows)
    assert json.load(open(out / "certify_summary.json"))["total"] == 2
    proc = _cli(["certify", "--config-path", str(path)], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
