"""VQAv2 annotation API.

A copy of ``certifiedgpt_tpu/vqa_tools/vqa.py``: a minimal but compatible
re-implementation of the official VQA loader. It indexes question and
annotation JSONs by question id, answers filtered id queries, and validates
and wraps prediction lists (``load_res``) so that ``VQAEval`` can score
them; predictions must cover exactly the annotated question ids.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union


class VQA:
    def __init__(
        self,
        annotation_file: Optional[Union[str, dict]] = None,
        question_file: Optional[Union[str, dict]] = None,
    ):
        self.dataset: Dict[str, Any] = {}
        self.questions: Dict[str, Any] = {}
        self.qa: Dict[int, dict] = {}
        self.qqa: Dict[int, dict] = {}
        self.img_to_qa: Dict[int, List[dict]] = {}
        if annotation_file is not None and question_file is not None:
            self.dataset = self._load(annotation_file)
            self.questions = self._load(question_file)
            self.create_index()

    @staticmethod
    def _load(source: Union[str, dict]) -> dict:
        if isinstance(source, str):
            with open(source, "r") as handle:
                return json.load(handle)
        return source

    def create_index(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.qa[ann["question_id"]] = ann
            self.img_to_qa.setdefault(ann["image_id"], []).append(ann)
        for q in self.questions.get("questions", []):
            self.qqa[q["question_id"]] = q

    # ------------------------------------------------------------------
    def get_ques_ids(
        self,
        img_ids: Optional[Iterable[int]] = None,
        ques_types: Optional[Iterable[str]] = None,
        ans_types: Optional[Iterable[str]] = None,
    ) -> List[int]:
        # official semantics (ref common/vqa_tools/vqa.py:80-113): an
        # EMPTY filter list means "no filter", same as None — callers
        # ported from the reference pass [] as the default
        anns = list(self.qa.values())
        if img_ids:
            img_ids = set(img_ids)
            anns = [a for a in anns if a["image_id"] in img_ids]
        if ques_types:
            ques_types = set(ques_types)
            anns = [a for a in anns if a.get("question_type") in ques_types]
        if ans_types:
            ans_types = set(ans_types)
            anns = [a for a in anns if a.get("answer_type") in ans_types]
        return [a["question_id"] for a in anns]

    def get_img_ids(self, ques_ids: Optional[Iterable[int]] = None) -> List[int]:
        # official semantics: no/empty filter returns one image_id PER
        # ANNOTATION (duplicates preserved), not the deduped key set
        if not ques_ids:
            return [a["image_id"] for a in self.qa.values()]
        return [self.qa[q]["image_id"] for q in ques_ids if q in self.qa]

    def load_qa(self, ques_id: int) -> dict:
        return self.qa[ques_id]

    def load_question(self, ques_id: int) -> dict:
        return self.qqa[ques_id]

    # ------------------------------------------------------------------
    def load_res(
        self, predictions: Union[str, Sequence[dict]], question_file=None
    ) -> "VQA":
        """Wrap ``[{"question_id": int, "answer": str}]`` predictions.

        Validates that predictions cover exactly the annotated question
        ids (the official behavior the reference relies on).
        """
        preds = (
            self._load(predictions) if isinstance(predictions, str) else predictions
        )
        questions = (
            self._load(question_file) if question_file else self.questions
        )
        if isinstance(preds, dict):
            preds = preds.get("annotations", preds.get("results", []))
        pred_ids = {p["question_id"] for p in preds}
        ann_ids = set(self.qa.keys())
        if pred_ids != ann_ids:
            missing = ann_ids - pred_ids
            extra = pred_ids - ann_ids
            raise ValueError(
                "Results do not correspond to the annotated question ids "
                f"(missing {len(missing)}, unexpected {len(extra)})"
            )
        res = VQA()
        res.questions = questions
        annotations = []
        for p in preds:
            ann = copy.deepcopy(self.qa[p["question_id"]])
            ann["answer"] = p["answer"]
            ann["answers"] = [{"answer": p["answer"]}]
            annotations.append(ann)
        res.dataset = {"annotations": annotations}
        res.create_index()
        return res
