"""Certify and predict agents, and certification of one item.

Port of ``certifiedgpt_tpu/agents/certify.py`` (the serial loops). For each
(image, question) of the certification subset:

    vocab   <- fixed label set (the question's candidate answers, or the
               dataset's top answers under ``vocab_mode: global``)
    g       <- Smooth(noisy generate -> normalize -> label, sigma)
    (c, R)  <- g.certify(x, n0, n, alpha)     (``certify`` mode)
    c       <- g.predict(x, n, alpha)         (``smoothing_predict`` mode)
    correct <- c maps to an answer the humans gave (VQA consensus > 0)

Per-image rows stream to ``certify_results.jsonl`` / ``predict_results.jsonl``
in the output dir, the summary goes to ``certify_summary.json`` /
``predict_summary.json``; a ``run.sigma_grid`` sweep writes each sigma's
files under ``sigma_<s>/`` and all summaries to ``certify_sweep.json``.
``certify_item`` certifies one item outside the agents (the chip script's
entry) and builds its row as the agents do (``certify_row``).

``run.dispatch_window`` chunks stay in flight while the host decodes
(``smoothing/classifier.py``). Under ``run.continuous`` both agents run the
continuous-batching scheduler (``smoothing/continuous.py``) over
``run.active_images`` slots: draws of several questions share every chunk,
rows land out of order and carry ``elapsed_seconds`` (wall clock since the
run began) instead of ``seconds``, and the summary adds ``continuous``,
``images_per_hour`` and ``mean_seconds_per_image`` = wall / images.

``run.enable_profile`` traces with ``common/profiling.py``: the serial
loops open the trace at image ``profile_step``, the continuous scheduler at
chunk ``profile_step``. Under data parallelism (``run.distributed`` with
more than one rank in the mesh's batch group) every chunk splits over the
ranks (``smoothing/classifier.py``); ``mc_batch`` is rounded down to a
multiple of the batch divisor, as in the JAX agent; every rank computes the
same rows, and rank 0 writes the files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from certifiedgpt_tpu_torch.agents.base import BaseAgent
from certifiedgpt_tpu_torch.common.profiling import Profiler
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.common.stages import StageClock
from certifiedgpt_tpu_torch.models.conversation import wrap_instruction
from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn
from certifiedgpt_tpu_torch.smoothing.continuous import ContinuousCertifier, LazySlice
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


@dataclasses.dataclass(frozen=True)
class SmoothingKnobs:
    """The knobs of a certify or predict config's ``run`` block, with the
    JAX agents' defaults."""

    sigma: float = 0.5            # noise_level
    n0: int = 100                 # certify_n0
    n: int = 1000                 # certify_n
    predict_n: int = 100
    alpha: float = 0.001          # certify_alpha
    mc_batch: int = 32
    max_new_tokens: int = 10
    seq_len: int = 64
    early_exit: bool = False
    early_abstain: bool = False
    early_stop_radius: Optional[float] = None
    seed: int = 42
    conv_template: Optional[str] = None
    noise_dist: str = "gaussian"
    dispatch_window: int = 4      # chunks in flight
    continuous: bool = False      # the continuous-batching scheduler
    active_images: int = 8        # its image slots

    @classmethod
    def from_run(cls, run: Mapping[str, Any]) -> "SmoothingKnobs":
        esr = run.get("early_stop_radius")
        return cls(
            sigma=float(run.get("noise_level", 0.5)),
            n0=int(run.get("certify_n0", 100)),
            n=int(run.get("certify_n", 1000)),
            predict_n=int(run.get("predict_n", 100)),
            alpha=float(run.get("certify_alpha", 0.001)),
            mc_batch=int(run.get("mc_batch", 32)),
            max_new_tokens=int(run.get("max_new_tokens", 10)),
            seq_len=int(run.get("seq_len", 64)),
            early_exit=bool(run.get("early_exit", False)),
            early_abstain=bool(run.get("early_abstain", False)),
            early_stop_radius=float(esr) if esr is not None else None,
            seed=int(run.get("seed", 42)),
            conv_template=run.get("conv_template"),
            noise_dist=str(run.get("noise_dist", "gaussian")),
            dispatch_window=int(run.get("dispatch_window", 4)),
            continuous=bool(run.get("continuous", False)),
            active_images=int(run.get("active_images", 8)),
        )


def make_smooth(model, knobs: SmoothingKnobs, instruction: str, vocab: AnswerVocabulary,
                clock: Optional[StageClock] = None, mesh=None,
                on_chunk: Optional[Callable[[int], None]] = None) -> Smooth:
    """``Smooth`` over noisy greedy generation of ``model`` on the wrapped
    ``instruction``, labelled by ``vocab``; ``mesh`` splits each chunk over
    its batch group; ``on_chunk`` runs before each chunk's dispatch."""
    sample_fn = make_sample_fn(
        model,
        wrap_instruction(instruction, knobs.conv_template),
        vocab,
        knobs.sigma,
        mc_batch=knobs.mc_batch,
        max_new_tokens=knobs.max_new_tokens,
        seq_len=knobs.seq_len,
        early_exit=knobs.early_exit,
        clock=clock,
        noise_dist=knobs.noise_dist,
        window=knobs.dispatch_window,
        mesh=mesh,
        on_chunk=on_chunk,
    )
    return Smooth(sample_fn, vocab.num_classes, knobs.sigma)


def _answer(label: int, vocab: AnswerVocabulary) -> str:
    return vocab.text_of(label) if label != ABSTAIN else "<abstain>"


def certify_row(smooth: Smooth, vocab: AnswerVocabulary, knobs: SmoothingKnobs,
                image: np.ndarray, gt_answers: List[str], index: int,
                question_id: int) -> Dict[str, Any]:
    """Certify one image and return its row of ``certify_results.jsonl``."""
    t0 = time.time()
    label, radius = smooth.certify(
        image, knobs.n0, knobs.n, knobs.alpha,
        seed=certify_seed(knobs.seed, index, knobs.sigma),
        early_abstain=knobs.early_abstain,
        early_stop_radius=knobs.early_stop_radius,
    )
    dt = time.time() - t0
    return {
        "index": index,
        "question_id": int(question_id),
        "label": int(label),
        "answer": _answer(label, vocab),
        "radius": float(radius),
        "correct": bool(label_correct(label, vocab, gt_answers)),
        "abstain": label == ABSTAIN,
        "seconds": round(dt, 3),
        "sigma": knobs.sigma,
        "n0": knobs.n0,
        "n": knobs.n,
        # draws labeled (< n0 + n when early stopping fired)
        "draws": int(smooth.last_draws),
    }


def predict_row(smooth: Smooth, vocab: AnswerVocabulary, knobs: SmoothingKnobs,
                image: np.ndarray, gt_answers: List[str], index: int,
                question_id: int) -> Dict[str, Any]:
    """Predict one image (``early_abstain`` turns on the exact
    completion-certain stopping) and return its row of
    ``predict_results.jsonl``."""
    t0 = time.time()
    label = smooth.predict(
        image, knobs.predict_n, knobs.alpha,
        seed=certify_seed(knobs.seed, index, knobs.sigma),
        early_stop=knobs.early_abstain,
    )
    dt = time.time() - t0
    return {
        "index": index,
        "question_id": int(question_id),
        "label": int(label),
        "answer": _answer(label, vocab),
        "correct": bool(label_correct(label, vocab, gt_answers)),
        "abstain": label == ABSTAIN,
        "seconds": round(dt, 3),
        "sigma": knobs.sigma,
        "n": knobs.predict_n,
        # draws labeled (< n when early stopping fired)
        "draws": int(smooth.last_draws),
    }


def certify_item(model, image: np.ndarray, question: str, gt_answers: List[str],
                 run_cfg: Mapping[str, Any], index: int, question_id: int = 0,
                 clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Certify one item with the knobs of a certify config's ``run`` block
    (``SmoothingKnobs.from_run``) against its candidate answers, and return
    the row ``CertifyAgent`` writes for it."""
    if not gt_answers:
        raise ValueError(
            "certification needs ground-truth candidate answers to fix the "
            "label set (Cohen's guarantee)"
        )
    knobs = SmoothingKnobs.from_run(run_cfg)
    vocab = AnswerVocabulary(gt_answers)
    smooth = make_smooth(model, knobs, question, vocab, clock)
    return certify_row(smooth, vocab, knobs, image, gt_answers, index, question_id)


class SmoothedVQAAgentBase(BaseAgent):
    """Shared plumbing for certify / smoothing_predict: the run block's
    knobs, the finetuned projection (``model.vqa_finetuned``), the dataset,
    the label set, and the serial and continuous loops over the dataset."""

    def __init__(self, config, device="cuda"):
        run = config.run
        super().__init__(config, device)
        self.knobs = SmoothingKnobs.from_run(run)
        # keep mc_batch a multiple of the mesh's batch axes (the MC axis
        # splits over dcn x data) instead of failing at the first image
        n_data = self.mesh.batch_divisor
        if n_data > 1 and self.knobs.mc_batch % n_data:
            rounded = max(self.knobs.mc_batch // n_data, 1) * n_data
            self.logger.warning("mc_batch %d not divisible by mesh data axis %d; using %d",
                                self.knobs.mc_batch, n_data, rounded)
            self.knobs = dataclasses.replace(self.knobs, mc_batch=rounded)
        self.max_images = run.get("max_images")
        # the image index (serial loops) or chunk index (continuous) is the
        # profile step
        self.profiler = Profiler(run, device)
        finetuned = self.load_finetuned({"llama_proj": self.model.params["llama_proj"]})
        if finetuned is not None:
            self.model.set_llama_proj(finetuned["llama_proj"])

    def eval_dataset(self):
        names = list(self.config.datasets.keys())
        for pos, name in enumerate(names):
            builder_cls = registry.get_builder_class(name)
            datasets = builder_cls(self.config.datasets.get(name) or {}).build_datasets()
            for split in ("val", "test", "train"):
                if split in datasets:
                    if pos + 1 < len(names):
                        self.logger.warning(
                            "certify uses only '%s'; ignoring configured "
                            "datasets %s (run them as separate configs)",
                            name, names[pos + 1:],
                        )
                    return datasets[split]
        raise RuntimeError("No dataset configured for certification")

    def build_vocab(self, item, dataset=None) -> AnswerVocabulary:
        """Label-set construction (``run.vocab_mode``):
        - ``per_question`` (default): the item's candidate answers + OTHER
        - ``global``: top-``vocab_top_k`` answers over the whole dataset's
          annotations (standard VQA-classifier vocabulary), built once.
        Both are fixed before sampling, as Cohen's guarantee requires.
        """
        mode = str(self.run_cfg.get("vocab_mode", "per_question"))
        if mode == "global":
            if not hasattr(self, "_global_vocab"):
                if dataset is None or not getattr(dataset, "annotations", None):
                    raise RuntimeError(
                        "vocab_mode=global needs a dataset with annotations"
                    )
                self._global_vocab = AnswerVocabulary.from_annotations(
                    dataset.annotations,
                    top_k=int(self.run_cfg.get("vocab_top_k", 3000)),
                )
                self.logger.info(
                    "global answer vocabulary: %d classes",
                    self._global_vocab.num_classes,
                )
            return self._global_vocab
        if not item.get("gt_answers"):
            raise RuntimeError(
                "Certification needs ground-truth candidate answers to fix "
                "the label set (Cohen's guarantee); configure the "
                "'evalvqav2' dataset, not a train/test split"
            )
        return AnswerVocabulary(item["gt_answers"])

    def smoothed_classifier(self, item, dataset=None):
        vocab = self.build_vocab(item, dataset)
        return make_smooth(self.model, self.knobs, item["instruction_input"], vocab,
                           mesh=self.mesh, on_chunk=self.profiler.poll), vocab

    def limit(self, dataset) -> int:
        """Items to run: the first ``max_images`` of the dataset."""
        limit = int(self.max_images) if self.max_images else len(dataset)
        return min(limit, len(dataset))

    def serial_run(self, dataset, mode: str,
                   make_row: Callable[..., Dict[str, Any]]) -> Dict[str, Any]:
        """Row by row over the first ``max_images`` items: each row streams
        to ``{mode}_results.jsonl``, the agent's ``summarize`` of all rows
        goes to ``{mode}_summary.json``."""
        rows: List[Dict[str, Any]] = []
        with open(self.out_path(f"{mode}_results.jsonl"), "w") as sink:
            for idx in range(self.limit(dataset)):
                item = dataset[idx]
                smooth, vocab = self.smoothed_classifier(item, dataset)
                self.profiler.maybe_start(0, idx)
                row = make_row(smooth, vocab, self.knobs, item["image"], item["gt_answers"],
                               idx, item["question_id"])
                rows.append(row)
                sink.write(json.dumps(row) + "\n")
                sink.flush()
                self.logger.info(
                    "%s[%d] qid=%s label=%s radius=%s correct=%s (%.2fs)",
                    mode, idx, row["question_id"], row["answer"], row.get("radius", "-"),
                    row["correct"], row["seconds"],
                )
        summary = self.summarize(rows)
        with open(self.out_path(f"{mode}_summary.json"), "w") as handle:
            json.dump(summary, handle, indent=2)
        self.logger.info("%s summary: %s", mode, summary)
        return summary

    def make_continuous(self, n0: int, n: int, mode: str = "certify") -> ContinuousCertifier:
        """The continuous-batching scheduler for certify (``mode="certify"``)
        or predict (``mode="predict"``, n0 = 0) with the run block's knobs:
        ``active_images`` slots, ``dispatch_window`` chunks in flight, and
        the exact early stopping of ``early_abstain`` (and, for certify,
        ``early_stop_radius``)."""
        k = self.knobs
        return ContinuousCertifier(
            self.model, sigma=k.sigma, n0=n0, n=n, alpha=k.alpha, mc_batch=k.mc_batch,
            max_new_tokens=k.max_new_tokens, seq_len=k.seq_len, num_slots=k.active_images,
            noise_dist=k.noise_dist, early_exit=k.early_exit, window=k.dispatch_window,
            mode=mode, early_abstain=k.early_abstain,
            early_stop_radius=k.early_stop_radius if mode == "certify" else None,
            mesh=self.mesh,
        )

    def _continuous_run(self, dataset, mode: str, n0: int, n: int) -> Dict[str, Any]:
        """The continuous loop of both agents (``run.continuous``): rows in
        the order their results land, each with ``elapsed_seconds``, the
        cumulative wall clock when it was finalized (images overlap, so a
        per-image duration does not exist); the summary's
        ``mean_seconds_per_image`` is wall / images. The random stream
        differs from the serial mode's, so the two agree draw for draw only
        at sigma 0."""
        k = self.knobs
        scheduler = self.make_continuous(n0, n, mode=mode)
        rows: List[Dict[str, Any]] = []
        t0 = time.time()
        with open(self.out_path(f"{mode}_results.jsonl"), "w") as sink:
            def on_result(res, job):
                label = res["label"]
                row = {
                    "index": res["index"],
                    "question_id": int(job.item["question_id"]),
                    "label": int(label),
                    "answer": _answer(label, job.vocab),
                    "correct": bool(label_correct(label, job.vocab, job.item["gt_answers"])),
                    "abstain": label == ABSTAIN,
                    "elapsed_seconds": round(time.time() - t0, 3),
                    "sigma": k.sigma,
                    "n": n,
                    # draws decoded for this image (< n0 + n when early
                    # stopping fired; other images' draws took the rest)
                    "draws": int(job.decoded),
                }
                if mode == "certify":
                    row["radius"] = float(res["radius"])
                    row["n0"] = n0
                rows.append(row)
                sink.write(json.dumps(row) + "\n")
                sink.flush()
                self.logger.info(
                    "%s[%d] qid=%s label=%s radius=%s correct=%s (%.1fs elapsed)",
                    mode, row["index"], row["question_id"], row["answer"],
                    row.get("radius", "-"), row["correct"], row["elapsed_seconds"],
                )

            scheduler.run(
                LazySlice(dataset, self.limit(dataset)),
                lambda text: wrap_instruction(text, k.conv_template),
                lambda item: self.build_vocab(item, dataset),
                seed=certify_seed(k.seed, 0, k.sigma),
                on_result=on_result,
                # the profile step is the dispatched chunk's index
                on_chunk=lambda chunk: self.profiler.maybe_start(0, chunk),
            )
        elapsed = time.time() - t0
        rows.sort(key=lambda r: r["index"])
        summary = self.summarize(rows)
        summary["mean_seconds_per_image"] = elapsed / max(len(rows), 1)
        summary["continuous"] = True
        summary["images_per_hour"] = 3600.0 / max(summary["mean_seconds_per_image"], 1e-9)
        with open(self.out_path(f"{mode}_summary.json"), "w") as handle:
            json.dump(summary, handle, indent=2)
        self.logger.info("%s summary: %s", mode, summary)
        return summary


def _mean_of(rows: List[Dict[str, Any]], key: str, default: float) -> float:
    """Mean of ``key`` over the rows that have it (a continuous row has no
    ``seconds``), else ``default``."""
    values = [r[key] for r in rows if key in r]
    return float(np.mean(values)) if values else float(default)


@registry.register_agent("image_text_certify")
class CertifyAgent(SmoothedVQAAgentBase):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        self.radius_grid = [
            float(r) for r in self.run_cfg.get("radius_grid", [0.5, 1.0, 2.0, 3.0])
        ]

    def run(self) -> Dict[str, Any]:
        # the dataset is the same for every sigma of a sweep: built once
        dataset = self.eval_dataset()
        sigma_grid = self.run_cfg.get("sigma_grid")
        if not sigma_grid:
            return self._run_single(dataset)
        sweep = {}
        base_out, base_knobs = self.output_dir, self.knobs
        try:
            for sigma in [float(s) for s in sigma_grid]:
                self.knobs = dataclasses.replace(base_knobs, sigma=sigma)
                self.output_dir = os.path.join(base_out, f"sigma_{sigma}")
                os.makedirs(self.output_dir, exist_ok=True)
                sweep[str(sigma)] = self._run_single(dataset)
        finally:
            self.output_dir, self.knobs = base_out, base_knobs
        with open(self.out_path("certify_sweep.json"), "w") as handle:
            json.dump(sweep, handle, indent=2)
        self.logger.info("sigma sweep complete: %s", list(sweep))
        return {"sweep": sweep}

    def _run_single(self, dataset) -> Dict[str, Any]:
        if self.knobs.continuous:
            return self._run_continuous(dataset)
        return self.serial_run(dataset, "certify", certify_row)

    def _run_continuous(self, dataset) -> Dict[str, Any]:
        return self._continuous_run(dataset, "certify", self.knobs.n0, self.knobs.n)

    def summarize(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        total = len(rows)
        if total == 0:
            return {"total": 0}
        k = self.knobs
        return {
            "total": total,
            "sigma": k.sigma,
            "n0": k.n0,
            "n": k.n,
            "alpha": k.alpha,
            "abstention_rate": sum(1 for r in rows if r["abstain"]) / total,
            "standard_accuracy": sum(1 for r in rows if r["correct"]) / total,
            "certified_accuracy_at_radius": {
                str(radius): sum(1 for r in rows if r["correct"] and r["radius"] >= radius)
                / total
                for radius in self.radius_grid
            },
            # < n0 + n when early_abstain / early_stop_radius fired
            "mean_draws_per_image": float(np.mean([r["draws"] for r in rows])),
            # continuous rows have no seconds: _continuous_run sets wall / images
            "mean_seconds_per_image": _mean_of(rows, "seconds", 0.0),
        }


@registry.register_agent("image_text_predict")
class PredictAgent(SmoothedVQAAgentBase):
    """``smoothing_predict`` mode: ``Smooth.predict`` over the subset."""

    def run(self) -> Dict[str, Any]:
        dataset = self.eval_dataset()
        if self.knobs.continuous:
            return self._run_continuous(dataset)
        return self.serial_run(dataset, "predict", predict_row)

    def _run_continuous(self, dataset) -> Dict[str, Any]:
        return self._continuous_run(dataset, "predict", 0, self.knobs.predict_n)

    def summarize(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        total = len(rows)
        k = self.knobs
        return {
            "total": total,
            "sigma": k.sigma,
            "n": k.predict_n,
            "alpha": k.alpha,
            "accuracy": sum(1 for r in rows if r["correct"]) / max(total, 1),
            "abstention_rate": sum(1 for r in rows if r["abstain"]) / max(total, 1),
            # continuous rows have no seconds: _continuous_run sets wall / images
            "mean_seconds_per_image": _mean_of(rows, "seconds", 0.0),
            # < n when run.early_abstain's completion-certain rule fired
            "mean_draws_per_image": _mean_of(rows, "draws", k.predict_n),
        }
