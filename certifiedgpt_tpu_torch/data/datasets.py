"""Datasets (host-side, numpy and PIL).

A copy of ``certifiedgpt_tpu/data/datasets.py``: VQAv2 train/eval/test and
CC-SBU caption alignment, plain Python classes whose items hold numpy
arrays.

- VQAv2 joins annotations to questions by ``question_id`` and reads COCO
  images as ``COCO_{split}2014_{image_id:012d}.jpg``, flat or under
  ``{split}2014/``.
- Train answers use confidence-weighted sampling (yes=2 / maybe=1 / no=0,
  normalized) from a generator seeded by (seed, epoch, index).
- ``VQAv2EvalDataset`` is deterministic and keeps every ground-truth
  answer: its items are what the certify and predict agents certify.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from certifiedgpt_tpu_torch.common.logging import get_logger

INSTRUCTION_TEMPLATES = [
    "[vqa] {}",
    "[vqa] Based on the image, respond to this question with a short answer: {}",
]
INSTRUCTION_WRAPPER = "<Img><ImageHere></Img> {} "
TEST_INSTRUCTION = (
    "[vqa] Based on the image, respond to this question with a short answer: {}"
)


def _load_json_list(paths: Sequence[str], key: str) -> List[dict]:
    items: List[dict] = []
    for path in paths:
        with open(path, "r") as handle:
            data = json.load(handle)
        if isinstance(data, dict):
            items.extend(data.get(key, []))
        elif isinstance(data, list):
            items.extend(data)
    return items


class BaseDataset:
    def __init__(
        self,
        vis_processor=None,
        text_processor=None,
        questions_paths: Sequence[str] = (),
        vis_paths: Optional[str] = None,
        annotation_paths: Sequence[str] = (),
        split: str = "train",
    ):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.vis_paths = vis_paths
        self.split = split
        self.questions = _load_json_list(questions_paths, "questions")
        self.annotations = _load_json_list(annotation_paths, "annotations")
        self.logger = get_logger()

    def __len__(self) -> int:
        return len(self.annotations)

    def set_processor(self, vis_processor, text_processor) -> None:
        self.vis_processor = vis_processor
        self.text_processor = text_processor

    def collater(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Stack array fields; keep text fields as lists."""
        out: Dict[str, Any] = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray):
                out[key] = np.stack(vals, axis=0)
            elif isinstance(vals[0], (int, np.integer)):
                out[key] = np.asarray(vals, np.int64)
            else:
                out[key] = vals
        return out

    @property
    def split_name(self) -> str:
        return self.split


class VQAv2Dataset(BaseDataset):
    """Train-split VQAv2 with confidence-weighted answer sampling."""

    def __init__(self, *args, seed: int = 0, coco_year: str = "2014", **kwargs):
        super().__init__(*args, **kwargs)
        self.coco_year = coco_year
        self.seed = seed
        self.epoch = 0  # set by Loader.set_epoch for fresh per-epoch sampling
        questions_dict = {q["question_id"]: q for q in self.questions}
        # keep only annotations whose question exists (join by question_id,
        # ref vqav2_dataset.py:43-77)
        self.annotations = [
            a for a in self.annotations if a.get("question_id") in questions_dict
        ]
        self.questions_dict = questions_dict

    def _image_path(self, image_id: int) -> str:
        file_name = f"COCO_{self.split}{self.coco_year}_{image_id:012d}.jpg"
        flat = os.path.join(self.vis_paths, file_name)
        if os.path.exists(flat):
            return flat
        # the COCO zips unpack into images/{split}{year}/ subdirectories
        # (scripts/download_coco.sh layout); support both
        return os.path.join(
            self.vis_paths, f"{self.split}{self.coco_year}", file_name
        )

    def _load_image(self, image_id: int) -> np.ndarray:
        image = Image.open(self._image_path(image_id)).convert("RGB")
        return self.vis_processor(image)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.Generator:
        """Per-call generator: deterministic in (seed, epoch, index) and
        safe under the loader's worker threads (a shared Generator is not
        thread-safe); answers still resample every epoch like the
        reference's per-__getitem__ random draws."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index])
        )

    def sample_answer(
        self, annotation: dict, rng: Optional[np.random.Generator] = None
    ) -> str:
        # no-rng calls draw fresh entropy (a fixed default would silently
        # turn sampling into a constant); __getitem__ passes the
        # deterministic per-item generator
        rng = rng if rng is not None else np.random.default_rng()
        weights: Dict[str, float] = collections.defaultdict(float)
        for ans in annotation.get("answers", []):
            text = ans.get("answer")
            if not text:
                continue
            conf = ans.get("answer_confidence")
            weights[text] += 2.0 if conf == "yes" else 1.0 if conf == "maybe" else 0.0
        answers = list(weights.keys())
        probs = np.asarray(list(weights.values()), np.float64)
        # the zero-total check must look at the SUM, not dict emptiness:
        # answers whose confidence is all 'no' create 0.0-weight entries
        # (defaultdict), and 0/0 normalization would put NaNs into
        # rng.choice and kill the epoch on one bad sample
        if not answers or probs.sum() <= 0:
            texts = [a["answer"] for a in annotation.get("answers", []) if a.get("answer")]
            if not texts:
                raise ValueError(
                    f"No answers for question_id {annotation.get('question_id')}"
                )
            return str(rng.choice(texts))
        probs = probs / probs.sum()
        return str(rng.choice(answers, p=probs))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        annotation = self.annotations[index]
        question_id = annotation["question_id"]
        question = self.questions_dict[question_id]["question"]
        image = self._load_image(annotation["image_id"])
        rng = self._item_rng(index)
        answer = self.sample_answer(annotation, rng)
        if self.text_processor is not None:
            answer = self.text_processor(answer)
            # the reference also runs the QUESTION through the text
            # processor before templating (ref vqav2_dataset.py:96), so
            # train prompts carry the lowercased/stripped question
            question = self.text_processor(question)
        template = INSTRUCTION_TEMPLATES[
            int(rng.integers(len(INSTRUCTION_TEMPLATES)))
        ]
        instruction = INSTRUCTION_WRAPPER.format(template.format(question))
        return {
            "image": image.astype(np.float32),
            "question_id": question_id,
            "instruction_input": instruction,
            "answer": answer,
        }


class VQAv2EvalDataset(VQAv2Dataset):
    """Deterministic eval split: fixed instruction, ground truth retained.

    This implements the ``evalvqav2`` capability the reference configures
    but never ships (its builder is commented out,
    ref ``image_text_pair_builder.py:25-96``).
    """

    def __getitem__(self, index: int) -> Dict[str, Any]:
        annotation = self.annotations[index]
        question_id = annotation["question_id"]
        question = self.questions_dict[question_id]["question"]
        image = self._load_image(annotation["image_id"])
        instruction = INSTRUCTION_WRAPPER.format(TEST_INSTRUCTION.format(question))
        answers = [a.get("answer", "") for a in annotation.get("answers", [])]
        return {
            "image": image.astype(np.float32),
            "question_id": question_id,
            "instruction_input": instruction,
            "gt_answers": answers,
            "question": question,
            # real annotation buckets so the official per-question-type /
            # per-answer-type accuracies can be produced
            # (ref vqa_eval.py:276-290; BASELINE.md per-category rows)
            "question_type": annotation.get("question_type", "unknown"),
            "answer_type": annotation.get("answer_type", "unknown"),
        }


class VQAv2TestDataset(BaseDataset):
    """Question-only test split (COCO test2015 filenames,
    ref ``vqav2_dataset.py:173-215``)."""

    def __init__(self, *args, coco_year: str = "2015", **kwargs):
        super().__init__(*args, **kwargs)
        self.coco_year = coco_year

    def __len__(self) -> int:
        return len(self.questions)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        q = self.questions[index]
        file_name = f"COCO_{self.split}{self.coco_year}_{q['image_id']:012d}.jpg"
        path = os.path.join(self.vis_paths, file_name)
        if not os.path.exists(path):
            path = os.path.join(
                self.vis_paths, f"{self.split}{self.coco_year}", file_name
            )
        image = Image.open(path).convert("RGB")
        image = self.vis_processor(image)
        instruction = INSTRUCTION_WRAPPER.format(
            TEST_INSTRUCTION.format(q["question"])
        )
        return {
            "image": image.astype(np.float32),
            "question_id": q["question_id"],
            "instruction_input": instruction,
        }


class CCSbuAlignDataset(BaseDataset):
    """Caption-alignment dataset: ``{image_id}.jpg`` + ``filter_cap.json``
    (ref ``cc_sbu_align_dataset.py:7-62``).

    Each sample draws a random prompt from the alignment pool
    (ref ``minigpt4.py:80-88`` draws per training sample from
    ``prompts/alignment.txt``); the pool comes from ``prompt_path`` /
    ``prompt_template`` or from the model via ``set_prompts``."""

    PROMPT = "<Img><ImageHere></Img> Describe this image in detail."

    def __init__(
        self,
        vis_processor=None,
        text_processor=None,
        vis_paths: Optional[str] = None,
        annotation_paths: Sequence[str] = (),
        split: str = "train",
        prompt_path: Optional[str] = None,
        prompt_template: str = "{}",
        seed: int = 0,
    ):
        super().__init__(
            vis_processor=vis_processor,
            text_processor=text_processor,
            vis_paths=vis_paths,
            split=split,
        )
        self.annotations = _load_json_list(annotation_paths, "annotations")
        self.seed = seed
        self.epoch = 0
        from certifiedgpt_tpu_torch.models.model_zoo import load_prompt_pool

        self.prompts: List[str] = (
            load_prompt_pool(prompt_path, prompt_template) or [self.PROMPT]
        )

    def set_prompts(self, prompts: Sequence[str]) -> None:
        """Adopt a model-provided prompt pool (model.prompt_path)."""
        if prompts:
            self.prompts = list(prompts)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        ann = self.annotations[index]
        image = Image.open(
            os.path.join(self.vis_paths, f"{ann['image_id']}.jpg")
        ).convert("RGB")
        image = self.vis_processor(image)
        # the caption is the RAW annotation text: the reference's CC-SBU
        # dataset never routes it through a text processor (ref
        # cc_sbu_align_dataset.py:48-52) — blip_caption's lowercase/
        # strip/50-word truncation would materially change the long
        # multi-sentence alignment targets
        caption = ann["caption"]
        # thread-safe deterministic per-(seed, epoch, index) draw, same
        # pattern as VQAv2Dataset._item_rng
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index])
        )
        prompt = self.prompts[int(rng.integers(len(self.prompts)))]
        return {
            "image": image.astype(np.float32),
            "instruction_input": prompt,
            "answer": caption,
            "question_id": index,
        }
