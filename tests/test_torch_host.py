"""Port: the host-side copies (tokenizer and prompt batches, VQA answer
normalization and accuracy, conversation templates, the smoothing
statistics, the answer vocabulary) give the JAX package's results, and
the port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest

from certifiedgpt_tpu.data import text as JT
from certifiedgpt_tpu.models.conversation import wrap_instruction as j_wrap
from certifiedgpt_tpu.smoothing import smoothing as JS
from certifiedgpt_tpu.vqa_tools import vqa_eval as JQ
from certifiedgpt_tpu_torch.agents.certify import label_correct
from certifiedgpt_tpu_torch.data import text as TT
from certifiedgpt_tpu_torch.models.conversation import wrap_instruction
from certifiedgpt_tpu_torch.smoothing import smoothing as TS
from certifiedgpt_tpu_torch.smoothing.classifier import (
    AnswerVocabulary,
    check_dispatch_window_hbm,
)
from certifiedgpt_tpu_torch.vqa_tools import vqa_eval as TQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ANSWERS = ["Two", "the Cat!", "couldnt", "3,000", "a dog.", "yes", "", "  Red  ", "ten"]


@pytest.mark.parametrize("seq_len", [48, 40])  # 40 truncates the post-image text
def test_gen_batch_and_decoding_match_jax(seq_len):
    instructions = ["<Img><ImageHere></Img> what animal is this?", "no image marker here",
                    "x" * 20 + "<ImageHere>" + "y" * 30]
    want = JT.build_gen_batch(JT.ByteTokenizer(), instructions, JT.BatchSpec(seq_len, 8))
    got = TT.build_gen_batch(TT.ByteTokenizer(), instructions, TT.BatchSpec(seq_len, 8))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    row = [72, 105, 2, 80, 0]
    assert TT.decode_until_eos(TT.ByteTokenizer(), row) == JT.decode_until_eos(
        JT.ByteTokenizer(), row)
    assert TT.clean_answer(" <s>A Dog</s> ") == JT.clean_answer(" <s>A Dog</s> ")


def test_vqa_normalization_and_accuracy_match_jax():
    for a in ANSWERS:
        assert TQ.normalize_answer(a) == JQ.normalize_answer(a)
    gts = ["2", "two", "2", "3", "2", "2", "2", "two", "2", "2"]
    for pred in ("2", "two", "3", "four"):
        assert TQ.VQAEval.answer_accuracy(pred, gts) == JQ.VQAEval.answer_accuracy(pred, gts)


def test_templates_and_vocabulary_match_jax():
    from certifiedgpt_tpu.smoothing.classifier import AnswerVocabulary as JVocab

    for template in (None, "vicuna0", "llama2", "minigptv2"):
        assert wrap_instruction("what?", template) == j_wrap("what?", template)
    jv, tv = JVocab(ANSWERS), AnswerVocabulary(ANSWERS)
    assert tv.labels == jv.labels and tv.num_classes == jv.num_classes
    for text in ("a cat", "2", "</s>Yes", "nothing"):
        assert tv.label_of(text) == jv.label_of(text)
    assert tv.text_of(tv.other_label) == "<other>"
    assert not label_correct(tv.other_label, tv, ["other"])
    assert not label_correct(TS.ABSTAIN, tv, ["2"])
    assert label_correct(tv.label_of("two"), tv, ["2"] * 10)


def test_smoothing_statistics_match_jax():
    for k, n in [(0, 10), (5, 10), (990, 1000), (1000, 1000)]:
        assert TS.clopper_pearson_lower(k, n, 0.001) == JS.clopper_pearson_lower(k, n, 0.001)
        assert TS.min_count_for_lower_bound(0.5, n, 0.001) == JS.min_count_for_lower_bound(
            0.5, n, 0.001)
    counts = np.array([3, 90, 7])
    assert TS.certify_from_counts(counts, counts, 100, 0.001, 0.5) == JS.certify_from_counts(
        counts, counts, 100, 0.001, 0.5)
    assert TS.predict_from_counts(counts, 0.001) == JS.predict_from_counts(counts, 0.001)


def test_dispatch_window_guard():
    assert check_dispatch_window_hbm(1, 96, 448, "cpu") == 96 * 448 * 448 * 3 * 4
    with pytest.raises(ValueError, match="free"):
        check_dispatch_window_hbm(4, 96, 448, free_bytes=10**8)
    assert check_dispatch_window_hbm(1, 2, 8, free_bytes=10**9) == 2 * 8 * 8 * 3 * 4


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import certifiedgpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(certifiedgpt_tpu_torch.__path__,
                                               "certifiedgpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "certifiedgpt_tpu" or m.startswith("certifiedgpt_tpu.")]
assert not bad, bad
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
print(" ".join(names))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20
    assert {f"certifiedgpt_tpu_torch.{m}" for m in (
        "smoothing.continuous", "agents.eval", "agents.finetune", "data.loader",
        "vqa_tools.vqa", "optim", "common.metrics", "common.checkpoint",
        "common.profiling", "utils.gcs", "utils.subset", "utils.dataset_stats",
        "parallel.mesh", "parallel.tensor_parallel", "parallel.processes",
        "parallel.dryrun", "parallel.pipeline")} <= names
    # the port's scripts (the quality runbook, the chat demo, the attack
    # runbook) import neither either; the last two import their port
    # modules at the top, so loading them imports what they run
    scripts = [os.path.join(REPO, "scripts", f"{name}.py") for name in (
        "verify_checkpoints_torch", "demo_chat_torch", "verify_attack_torch")]
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"for i, script in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', script)\n"
        "    mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import certifiedgpt_tpu_torch.launch\n"
        "for name in ('certifiedgpt_tpu_torch.models.conversation',\n"
        "             'certifiedgpt_tpu_torch.attack.agent'):\n"
        "    assert name in sys.modules, name\n"
        "bad = [m for m in sys.modules if m == 'certifiedgpt_tpu' "
        "or m.startswith('certifiedgpt_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
