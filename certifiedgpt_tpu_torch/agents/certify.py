"""Certification of one (image, question) item.

Port of the per-image step of ``certifiedgpt_tpu/agents/certify.py``
(``CertifyAgent._run_single``, :424-471): fix the label set from the
question's candidate answers, build the smoothed classifier (noisy greedy
generate -> normalize -> label), run ``Smooth.certify`` and report the row
the agent writes to ``certify_results.jsonl``. The YAML launcher, the
dataset loop, the sigma sweep and the continuous scheduler wait for later
slices.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from certifiedgpt_tpu_torch.common.stages import StageClock
from certifiedgpt_tpu_torch.models.conversation import wrap_instruction
from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn
from certifiedgpt_tpu_torch.smoothing.smoothing import ABSTAIN, Smooth
from certifiedgpt_tpu_torch.vqa_tools.vqa_eval import VQAEval


def certify_seed(base_seed: int, index: int, sigma: float) -> int:
    """Per-image RNG seed with sigma folded in (splitmix64 finalizer, 62
    bits): every (image, sigma) cell of a sweep draws an independent
    stream. Identical to the JAX package's."""
    sigma_bits = int(np.float64(sigma).view(np.uint64))
    h = (base_seed * 0x9E3779B97F4A7C15 + index) & 0xFFFFFFFFFFFFFFFF
    h ^= sigma_bits
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return int((h ^ (h >> 31)) & 0x3FFFFFFFFFFFFFFF)


def is_correct(label_text: str, gt_answers: List[str]) -> bool:
    """Correct when the official consensus accuracy is positive."""
    return VQAEval.answer_accuracy(label_text, gt_answers) > 0.0


def label_correct(label: int, vocab: AnswerVocabulary, gt_answers: List[str]) -> bool:
    """Label-level correctness; ABSTAIN and the catch-all OTHER class are
    never correct."""
    if label == ABSTAIN or label == vocab.other_label:
        return False
    return is_correct(vocab.text_of(label), gt_answers)


def certify_item(model, image: np.ndarray, question: str, gt_answers: List[str],
                 run_cfg: Dict[str, Any], index: int, question_id: int = 0,
                 clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Certify one item with the knobs of a certify config's ``run`` block
    (``noise_level``, ``certify_n0``, ``certify_n``, ``certify_alpha``,
    ``mc_batch``, ``max_new_tokens``, ``seq_len``, ``early_exit``,
    ``early_abstain``, ``early_stop_radius``, ``seed``, ``conv_template``,
    ``noise_dist``)
    and return the per-image row of ``certify_results.jsonl``."""
    sigma = float(run_cfg.get("noise_level", 0.5))
    n0 = int(run_cfg.get("certify_n0", 100))
    n = int(run_cfg.get("certify_n", 1000))
    alpha = float(run_cfg.get("certify_alpha", 0.001))
    esr = run_cfg.get("early_stop_radius")
    if not gt_answers:
        raise ValueError(
            "certification needs ground-truth candidate answers to fix the "
            "label set (Cohen's guarantee)"
        )
    vocab = AnswerVocabulary(gt_answers)
    sample_fn = make_sample_fn(
        model,
        wrap_instruction(question, run_cfg.get("conv_template")),
        vocab,
        sigma,
        mc_batch=int(run_cfg.get("mc_batch", 32)),
        max_new_tokens=int(run_cfg.get("max_new_tokens", 10)),
        seq_len=int(run_cfg.get("seq_len", 64)),
        early_exit=bool(run_cfg.get("early_exit", False)),
        clock=clock,
        noise_dist=str(run_cfg.get("noise_dist", "gaussian")),
    )
    smooth = Smooth(sample_fn, vocab.num_classes, sigma)
    t0 = time.time()
    label, radius = smooth.certify(
        image, n0, n, alpha,
        seed=certify_seed(int(run_cfg.get("seed", 42)), index, sigma),
        early_abstain=bool(run_cfg.get("early_abstain", False)),
        early_stop_radius=float(esr) if esr is not None else None,
    )
    dt = time.time() - t0
    return {
        "index": index,
        "question_id": int(question_id),
        "label": int(label),
        "answer": vocab.text_of(label) if label != ABSTAIN else "<abstain>",
        "radius": float(radius),
        "correct": bool(label_correct(label, vocab, gt_answers)),
        "abstain": label == ABSTAIN,
        "seconds": round(dt, 3),
        "sigma": sigma,
        "n0": n0,
        "n": n,
        "draws": int(smooth.last_draws),
    }
