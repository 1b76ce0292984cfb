"""Port parity of the greedy eval slice, on the CPU: the port's ``EvalAgent``
writes the JAX agent's predictions and summary at noise 0 on the same
weights (every ``dispatch_window``, the last batch padded), and the test
split's submission file; ``Loader``, ``VQA``/``VQAEval.evaluate``,
``token_f1`` and ``add_input_noise`` match the JAX package's; each decode
knob (beam search, sampling, the repetition penalty, ``min_length``) gives
the JAX agent's predictions."""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_launch import ANSWERS, jax_tree, port_on_jax_weights, vqa  # noqa: F401

from certifiedgpt_tpu.agents import eval as JE
from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu.data.loader import Loader as JLoader
from certifiedgpt_tpu.vqa_tools.vqa import VQA as JVQA
from certifiedgpt_tpu.vqa_tools.vqa_eval import VQAEval as JVQAEval
from certifiedgpt_tpu_torch.agents import eval as TE
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.agents.finetune import add_input_noise
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.data.loader import HostCopy, Loader, to_device
from certifiedgpt_tpu_torch.vqa_tools.vqa import VQA
from certifiedgpt_tpu_torch.vqa_tools.vqa_eval import VQAEval


def _eval_run(make, side, name, **run):
    cfg = make("image_text_eval", f"{side}-{name}", **run)
    agent = (j_setup_agent(JConfig(cfg)) if side == "jax"
             else setup_agent(Config(cfg), device="cpu"))
    result = agent.run()
    agent.finalize()
    return result, make.root / "out" / f"{side}-{name}"


@pytest.mark.parametrize("window", [1, 2, 3])
def test_eval_matches_jax_at_noise_zero(vqa, port_on_jax_weights, window):  # noqa: F811
    """Six questions in batches of four (the second padded by repeating its
    last row), noise 0, early exit on: the port's predictions and summary
    equal the JAX agent's, at every look-ahead window."""
    run = dict(batch_size=4, noise_level=0.0, early_exit=True, dispatch_window=window,
               max_new_tokens=5)
    j_result, j_out = _eval_run(vqa, "jax", f"eval-{window}", **run)
    t_result, t_out = _eval_run(vqa, "torch", f"eval-{window}", **run)
    got = json.load(open(t_out / "eval_results.json"))
    want = json.load(open(j_out / "eval_results.json"))
    assert got == want
    assert t_result == j_result == got["summary"]
    assert len(got["predictions"]) == len(ANSWERS)
    assert set(got["summary"]) == {"overall_accuracy", "per_answer_type", "per_question_type",
                                   "exact_match", "token_f1", "answer_bias", "num_questions",
                                   "noise_level"}


def test_eval_noise_draws_from_the_step_generator(vqa, monkeypatch):
    """Batch ``step`` draws its noise from a generator seeded by (seed,
    step); the look-ahead changes nothing."""
    seen = []
    noise = TE.add_input_noise

    def spy(images, sigma, dist, generator):
        seen.append(generator.initial_seed())
        return noise(images, sigma, dist, generator)

    monkeypatch.setattr(TE, "add_input_noise", spy)
    preds = []
    for window in (1, 3):
        _, out = _eval_run(vqa, "torch", f"noisy-{window}", batch_size=2, noise_level=0.5,
                           dispatch_window=window)
        preds.append(json.load(open(out / "eval_results.json"))["predictions"])
    assert preds[0] == preds[1]
    assert seen == [TE.chunk_seed(3, step) for step in range(3)] * 2


def test_eval_window_checks_memory_for_the_padded_batch(vqa, monkeypatch):
    calls = []

    def guard(window, rows, img, device=None, **kw):
        calls.append((window, rows, img))
        raise ValueError("too much device memory")

    monkeypatch.setattr(TE, "check_dispatch_window_hbm", guard)
    agent = setup_agent(Config(vqa("image_text_eval", "guard", dispatch_window=64,
                                   batch_size=3)), device="cpu")
    with pytest.raises(ValueError, match="device memory"):
        agent.run()
    assert calls == [(64, 3, agent.model.cfg.vit.img_size)]


def test_eval_test_split_writes_the_submission_file(tmp_path, port_on_jax_weights):  # noqa: F811
    img_dir = tmp_path / "timages"
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    questions = []
    for i in range(3):
        image_id = 7000 + i
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"COCO_test2015_{image_id:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": image_id, "question": f"q{i}?"})
    (tmp_path / "tq.json").write_text(json.dumps({"questions": questions}))

    def cfg(side):
        return {
            "model": {"arch": "minigpt4", "model_size": "tiny"},
            "datasets": {"testvqav2": {
                "vis_processor": {"test": {"name": "blip2_image_val", "image_size": 28}},
                "build_info": {"images": {"storage": str(img_dir)},
                               "questions": {"test": [str(tmp_path / "tq.json")]}},
            }},
            "run": {"agent": "image_text_eval", "batch_size": 2, "seq_len": 48,
                    "max_new_tokens": 3, "output_dir": str(tmp_path / f"out-{side}")},
        }

    j_result = j_setup_agent(JConfig(cfg("jax"))).run()
    t_result = setup_agent(Config(cfg("torch")), device="cpu").run()
    assert t_result["num_questions"] == j_result["num_questions"] == 3
    got = json.load(open(tmp_path / "out-torch" / "vqa_test_predictions.json"))
    want = json.load(open(tmp_path / "out-jax" / "vqa_test_predictions.json"))
    assert got == want and {p["question_id"] for p in got} == {1, 2, 3}
    assert not (tmp_path / "out-torch" / "eval_results.json").exists()


@pytest.mark.parametrize("knob,value", [("num_beams", 2), ("do_sample", True),
                                        ("repetition_penalty", 1.2), ("min_length", 2)])
def test_unported_decode_knobs_are_refused(vqa, port_on_jax_weights, knob, value):  # noqa: F811
    """Each decode knob of the JAX eval agent now runs in the port: beam
    search, sampling (with one token left in the nucleus, so that the draw
    is the same in both packages), the repetition penalty and
    ``min_length`` give the JAX agent's predictions and summary at noise 0."""
    run = dict(batch_size=4, noise_level=0.0, max_new_tokens=4, **{knob: value})
    if knob == "do_sample":
        run["top_p"] = 1e-6
    j_result, j_out = _eval_run(vqa, "jax", f"knob-{knob}", **run)
    t_result, t_out = _eval_run(vqa, "torch", f"knob-{knob}", **run)
    got = json.load(open(t_out / "eval_results.json"))
    assert got == json.load(open(j_out / "eval_results.json"))
    assert t_result == j_result == got["summary"] and len(got["predictions"]) == len(ANSWERS)


class _Numbers:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {"i": idx, "x": np.full((2,), idx, np.float32)}

    def collater(self, samples):
        return {"i": np.asarray([s["i"] for s in samples], np.int64),
                "x": np.stack([s["x"] for s in samples])}


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=7, drop_last=False),
    dict(batch_size=4, shuffle=True, seed=7, drop_last=True, num_workers=1, prefetch=0),
    dict(batch_size=3, shuffle=False, drop_last=False),
    dict(batch_size=4, shuffle=True, seed=2, drop_last=False, process_index=1, process_count=2),
    dict(batch_size=6, shuffle=True, seed=2, drop_last=False, process_index=2, process_count=3),
], ids=["shuffle", "drop-last", "ordered", "process-1-of-2", "process-2-of-3"])
def test_loader_order_matches_jax(kw):
    """The JAX Loader's batches in its order for each seed and epoch: one
    process, and this process's slice of each global batch when there are
    more (its rows, the wrapped tail of a partial batch and
    ``__local_real_rows__``, as the JAX ``_local_slice`` gives them)."""
    kw = dict(kw)
    several = kw.get("process_count", 1) > 1
    for epoch in (0, 1):
        got_loader = Loader(_Numbers(11), **kw)
        want_loader = JLoader(_Numbers(11), **({} if several else
                                               dict(process_index=0, process_count=1)), **kw)
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got_loader) == len(want_loader) == len(want)
        assert [b["i"].tolist() for b in got] == [b["i"].tolist() for b in want]
        if several:
            assert [b["__local_real_rows__"] for b in got] == \
                [b["__local_real_rows__"] for b in want]
            assert all(set(w) == set(g) for g, w in zip(got, want))
        else:
            assert all(set(w) - set(g) == {"__local_real_rows__"} for g, w in zip(got, want))


def test_to_device_and_host_copy_on_the_cpu():
    batch = {"image": np.ones((2, 3), np.float32), "ids": np.arange(4, dtype=np.int32),
             "question": ["a", "b"]}
    dev = to_device(batch, "cpu")
    batch["image"][:] = 7.0  # the snapshot was taken when to_device returned
    assert torch.equal(dev["image"], torch.ones((2, 3)))
    assert dev["ids"].dtype == torch.int32 and dev["question"] == ["a", "b"]
    np.testing.assert_array_equal(HostCopy(dev["ids"] + 1).numpy(), np.arange(1, 5))


def _vqa_files():
    qs, anns, preds = [], [], []
    for i, (answers, pred) in enumerate([(["2"] * 7 + ["two"] * 3, "two"),
                                         (["yes"] * 10, "no"), (["red"] * 2 + ["blue"] * 8, "Red.")]):
        qs.append({"question_id": i, "image_id": 50 + i, "question": f"q{i}"})
        anns.append({"question_id": i, "image_id": 50 + i,
                     "question_type": ("how many", "is the", "what color")[i],
                     "answer_type": ("number", "yes/no", "other")[i],
                     "answers": [{"answer": a, "answer_id": j} for j, a in enumerate(answers)]})
        preds.append({"question_id": i, "answer": pred})
    return {"annotations": anns}, {"questions": qs}, preds


def test_vqa_and_evaluate_match_jax():
    anns, qs, preds = _vqa_files()
    got_vqa, want_vqa = VQA(anns, qs), JVQA(anns, qs)
    assert got_vqa.get_ques_ids(ans_types=["other"]) == want_vqa.get_ques_ids(ans_types=["other"])
    assert got_vqa.get_img_ids([0, 2]) == want_vqa.get_img_ids([0, 2])
    got = VQAEval(got_vqa, got_vqa.load_res(preds), n=2)
    want = JVQAEval(want_vqa, want_vqa.load_res(preds), n=2)
    assert got.evaluate() == want.evaluate()
    assert (got.eval_qa, got.eval_ques_type, got.eval_ans_type) == (
        want.eval_qa, want.eval_ques_type, want.eval_ans_type)
    assert got.evaluate([0, 1]) == want.evaluate([0, 1])
    with pytest.raises(ValueError, match="do not correspond"):
        got_vqa.load_res(preds[:2])


def test_token_f1_matches_jax():
    for pred, ref in [("a red car", "red car"), ("two", "2"), ("", ""), ("yes", ""),
                      ("the big dog", "a small cat"), ("blue blue sky", "blue sky")]:
        assert TE.token_f1(pred, ref) == JE.token_f1(pred, ref)


def test_add_input_noise():
    images = torch.zeros((2, 4, 4, 3))
    assert add_input_noise(images, 0.0, "gaussian", None) is images
    g = torch.Generator().manual_seed(4)
    uniform = add_input_noise(images, 0.5, "uniform", g)
    assert float(uniform.min()) >= 0.0 and float(uniform.max()) <= 0.5
    gauss = add_input_noise(images, 0.5, "gaussian", torch.Generator().manual_seed(4))
    torch.testing.assert_close(
        gauss, 0.5 * torch.randn((2, 4, 4, 3), generator=torch.Generator().manual_seed(4)),
        rtol=0, atol=0)
