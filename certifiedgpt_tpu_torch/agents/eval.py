"""Eval agent (``image_text_eval``).

Port of ``certifiedgpt_tpu/agents/eval.py``: load the finetuned projection
(``model.vqa_finetuned``), add the run's input noise to each batch of the
val split, generate answers through the batched KV-cache decode, clean them
up and score them with the official VQA protocol (``vqa_tools``). Decoding
is greedy by default; ``num_beams`` > 1 runs beam search (``generate_beam``,
with ``length_penalty``), and ``do_sample`` (``temperature``, ``top_p``),
``repetition_penalty`` != 1 and ``min_length`` > 1 run ``generate`` with
those knobs; beam search applies none of the three (a warning says so).
A split with no ground truth (``testvqav2``) writes the VQA submission file
``vqa_test_predictions.json`` instead.

Aux metrics as in the JAX package: exact match, token-level F1 and the
answer bias (how often the model gives its most frequent answer);
BERTScore when ``run.bertscore`` is set and the optional ``bert_score``
package imports.

Every batch is padded to ``batch_size`` rows by repeating its last row, so
the decode sees one shape; padded rows are dropped after decoding. Up to
``run.dispatch_window`` batches (default 2) stay in flight: a batch's
generate is queued on the card with its tokens' copy to pinned host memory
(``data.loader.HostCopy``), and the host decodes a batch's answers only
once the window is full. Batch ``step``'s noise and its token sampling
draw from two generators seeded from (seed, step) by
``split_noise_sample_seeds``, so the two streams are disjoint.

Data parallelism (``run.distributed``, a mesh batch group of more than one
rank), as the JAX agent shards a batch: every rank loads every batch, pads
it to a multiple of the batch divisor, draws the whole batch's noise, runs
its block of rows and gathers the tokens; every rank scores, rank 0 writes.
Greedy and beam tokens are the one-process ones; the token sampler's draws
are of each rank's rows, so a sampled answer differs from one process's.
"""

from __future__ import annotations

import json
import os
from collections import Counter, deque
from typing import Any, Dict, List

import numpy as np
import torch

from certifiedgpt_tpu_torch.agents.base import BaseAgent
from certifiedgpt_tpu_torch.agents.finetune import add_input_noise
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.data.loader import HostCopy, Loader, to_device
from certifiedgpt_tpu_torch.data.text import (
    BatchSpec,
    build_gen_batch,
    clean_answer,
    decode_until_eos,
)
from certifiedgpt_tpu_torch.models.conversation import wrap_instruction
from certifiedgpt_tpu_torch.models.minigpt4 import generate, generate_beam, generate_greedy
from certifiedgpt_tpu_torch.smoothing.classifier import check_dispatch_window_hbm, chunk_seed
from certifiedgpt_tpu_torch.vqa_tools.vqa import VQA
from certifiedgpt_tpu_torch.vqa_tools.vqa_eval import VQAEval, normalize_answer

def split_noise_sample_seeds(seed: int, step: int):
    """Seeds of eval step ``step``'s two generators: the input noise's,
    ``chunk_seed(seed, step)``, and the token sampler's, a splitmix64 of
    that seed, so the noise and the sampling draw disjoint streams."""
    noise_seed = chunk_seed(seed, step)
    return noise_seed, chunk_seed(noise_seed, 1)


def maybe_bertscore(predictions, references, logger):
    """BERTScore F1 when the optional ``bert_score`` package imports; None
    otherwise."""
    try:
        from bert_score import score as bert_score_fn
    except ImportError:
        logger.warning("bert_score not installed; skipping BERTScore")
        return None
    try:
        _, _, f1 = bert_score_fn(predictions, references, lang="en")
        return float(f1.mean())
    except Exception as exc:  # an optional metric: its failure ends nothing
        logger.warning("BERTScore failed: %s", exc)
        return None


def token_f1(prediction: str, reference: str) -> float:
    """Token-level F1 of two normalized answers."""
    pred = normalize_answer(prediction).split()
    ref = normalize_answer(reference).split()
    if not pred or not ref:
        return float(pred == ref)
    common = Counter(pred) & Counter(ref)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred)
    recall = overlap / len(ref)
    return 2 * precision * recall / (precision + recall)


@registry.register_agent("image_text_eval")
class EvalAgent(BaseAgent):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        run = self.run_cfg
        self.batch_size = int(run.get("batch_size", 4))
        self.seq_len = int(run.get("seq_len", 128))
        self.max_new_tokens = int(run.get("max_new_tokens", 10))
        self.noise_level = float(run.get("noise_level", 0.0))
        self.noise_dist = str(run.get("noise_dist", "gaussian"))
        self.seed = int(run.get("seed", 42))
        self.early_exit = bool(run.get("early_exit", False))
        self.conv_template = run.get("conv_template")
        # the decode knobs of the JAX agent, with its defaults
        self.num_beams = int(run.get("num_beams", 1))
        self.length_penalty = float(run.get("length_penalty", 1.0))
        self.sampling = {
            "do_sample": bool(run.get("do_sample", False)),
            "temperature": float(run.get("temperature", 1.0)),
            "top_p": float(run.get("top_p", 0.9)),
            "repetition_penalty": float(run.get("repetition_penalty", 1.0)),
            "min_length": int(run.get("min_length", 1)),
        }
        knobs = self.sampling
        self.knobs_on = (knobs["do_sample"] or knobs["repetition_penalty"] != 1.0
                         or knobs["min_length"] > 1)
        if self.num_beams > 1 and self.knobs_on:
            self.logger.warning("num_beams>1: do_sample/repetition_penalty/min_length are "
                                "not applied by beam search")
        finetuned = self.load_finetuned({"llama_proj": self.model.params["llama_proj"]})
        if finetuned is not None:
            self.model.set_llama_proj(finetuned["llama_proj"])

    def wrap_instructions(self, instructions):
        return [wrap_instruction(inst, self.conv_template) for inst in instructions]

    def generate(self, batch: Dict[str, torch.Tensor], step: int) -> torch.Tensor:
        """Queue one padded batch's noisy decode (greedy, beam search or
        with the sampling knobs); returns the token ids
        ``[rows, max_new_tokens]`` on the device (under data parallelism
        each rank decodes its rows and the tokens are gathered)."""
        noise_seed, sample_seed = split_noise_sample_seeds(self.seed, step)
        noise_gen = torch.Generator(device=self.device)
        noise_gen.manual_seed(noise_seed)
        images = add_input_noise(batch["image"], self.noise_level, self.noise_dist, noise_gen)
        gen_batch = {"image": images,
                     **{k: batch[k].long() for k in ("input_ids", "attention_mask", "img_pos")}}
        if self.mesh.batch_group is not None:
            gen_batch = {k: self.mesh.local_rows(v) for k, v in gen_batch.items()}
            return self.mesh.gather_rows(self._generate(gen_batch, sample_seed))
        return self._generate(gen_batch, sample_seed)

    def _generate(self, gen_batch: Dict[str, torch.Tensor], sample_seed: int) -> torch.Tensor:
        tok = self.model.tokenizer
        args = (self.model.params, self.model.cfg, gen_batch, self.max_new_tokens,
                tok.eos_token_id, tok.pad_token_id)
        if self.num_beams > 1:
            return generate_beam(*args, num_beams=self.num_beams,
                                 length_penalty=self.length_penalty)
        if self.knobs_on:
            sample_gen = torch.Generator(device=self.device)
            sample_gen.manual_seed(sample_seed)
            return generate(*args, **self.sampling, generator=sample_gen,
                            early_exit=self.early_exit)
        return generate_greedy(*args, early_exit=self.early_exit)

    # ------------------------------------------------------------------
    def create_loader(self) -> Loader:
        names = list(self.config.datasets.keys())
        for pos, name in enumerate(names):
            builder_cls = registry.get_builder_class(name)
            datasets = builder_cls(self.config.datasets.get(name) or {}).build_datasets()
            for split in ("val", "test"):
                if split in datasets:
                    if pos + 1 < len(names):
                        self.logger.warning(
                            "eval scores only '%s'; ignoring configured "
                            "datasets %s (run them as separate configs)",
                            name, names[pos + 1:],
                        )
                    return Loader(
                        datasets[split],
                        batch_size=self.batch_size,
                        shuffle=False,
                        drop_last=False,
                        num_workers=int(self.run_cfg.get("num_workers", 4)),
                    )
        raise RuntimeError("No val/test split configured for eval")

    def decode_tokens(self, tokens: np.ndarray) -> List[str]:
        return [clean_answer(decode_until_eos(self.model.tokenizer, row)) for row in tokens]

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        loader = self.create_loader()
        spec = BatchSpec(seq_len=self.seq_len, num_img_tokens=self.model.cfg.num_img_tokens)
        predictions: List[Dict[str, Any]] = []
        gt_annotations: List[dict] = []
        gt_questions: List[dict] = []

        # one decode shape: batch_size rows, padded to a multiple of the
        # mesh's batch divisor
        div = self.mesh.batch_divisor
        pad_to = -(-self.batch_size // div) * div
        # each batch in flight holds its padded images on the device
        window = max(1, int(self.run_cfg.get("dispatch_window", 2)))
        check_dispatch_window_hbm(window, pad_to, self.model.cfg.vit.img_size,
                                  self.device, logger=self.logger)
        inflight: deque = deque()

        def consume(entry) -> None:
            pending, n, batch = entry
            answers = self.decode_tokens(pending.numpy()[:n])
            gt_lists = batch.get("gt_answers", [[] for _ in range(n)])
            for i, ans in enumerate(answers):
                qid = int(batch["question_id"][i])
                predictions.append({"question_id": qid, "answer": ans})
                gt_annotations.append({
                    "question_id": qid,
                    "image_id": qid,
                    "question_type": batch.get("question_type", ["unknown"] * n)[i],
                    "answer_type": batch.get("answer_type", ["unknown"] * n)[i],
                    "answers": [{"answer": a, "answer_id": j + 1}
                                for j, a in enumerate(gt_lists[i])],
                })
                gt_questions.append({
                    "question_id": qid,
                    "image_id": qid,
                    "question": batch.get("question", [""] * n)[i],
                })

        for step, batch in enumerate(loader):
            text = build_gen_batch(self.model.tokenizer,
                                   self.wrap_instructions(batch["instruction_input"]), spec)
            n = batch["image"].shape[0]
            images = batch["image"]
            if n < pad_to:
                # one decode shape for every batch; padded rows are dropped
                reps = pad_to - n
                images = np.concatenate([images, np.repeat(images[-1:], reps, 0)])
                text = {key: np.concatenate([val, np.repeat(val[-1:], reps, 0)], axis=0)
                        for key, val in text.items()}
            dev = to_device({"image": images.astype(np.float32), **text}, self.device)
            inflight.append((HostCopy(self.generate(dev, step)), n, batch))
            if len(inflight) >= window:
                consume(inflight.popleft())
        while inflight:
            consume(inflight.popleft())

        n_empty = sum(1 for a in gt_annotations if not a["answers"])
        if gt_annotations and 0 < n_empty < len(gt_annotations):
            # the official accuracy counts an answerless question as 0.0,
            # while exact/f1 below leave it out: say so
            self.logger.warning(
                "%d/%d questions have no ground-truth answers; official "
                "accuracy counts them as 0.0 while exact/f1 exclude them",
                n_empty, len(gt_annotations),
            )
        if not any(a["answers"] for a in gt_annotations):
            # a test split (no question has ground truth): the official
            # VQA submission format
            path = os.path.join(self.output_dir, "vqa_test_predictions.json")
            with open(self.out_path("vqa_test_predictions.json"), "w") as handle:
                json.dump(predictions, handle)
            self.logger.info("wrote %d test predictions to %s", len(predictions), path)
            return {"num_questions": len(predictions), "predictions_path": path}

        vqa = VQA({"annotations": gt_annotations}, {"questions": gt_questions})
        res = vqa.load_res(predictions)
        accuracy = VQAEval(vqa, res, n=2).evaluate()

        gt_first = {a["question_id"]: a["answers"][0]["answer"]
                    for a in gt_annotations if a["answers"]}
        scored = [p for p in predictions if p["question_id"] in gt_first]
        exact = float(np.mean([
            normalize_answer(p["answer"]) == normalize_answer(gt_first[p["question_id"]])
            for p in scored
        ])) if scored else 0.0
        f1 = float(np.mean([token_f1(p["answer"], gt_first[p["question_id"]])
                            for p in scored])) if scored else 0.0
        counts = Counter(normalize_answer(p["answer"]) for p in predictions)
        bias_answer, bias_count = counts.most_common(1)[0] if counts else ("", 0)

        bert_f1 = None
        if self.run_cfg.get("bertscore", False):
            bert_f1 = maybe_bertscore([p["answer"] for p in scored],
                                      [gt_first[p["question_id"]] for p in scored], self.logger)

        results = {
            "overall_accuracy": accuracy["overall"],
            "per_answer_type": accuracy["perAnswerType"],
            "per_question_type": accuracy["perQuestionType"],
            "exact_match": exact,
            "token_f1": f1,
            "answer_bias": {
                "answer": bias_answer,
                "fraction": bias_count / max(len(predictions), 1),
            },
            "num_questions": len(predictions),
            "noise_level": self.noise_level,
        }
        if bert_f1 is not None:
            results["bertscore_f1"] = bert_f1
        with open(self.out_path("eval_results.json"), "w") as handle:
            json.dump({"summary": results, "predictions": predictions}, handle, indent=2)
        self.logger.info("eval results: %s", results)
        return results
