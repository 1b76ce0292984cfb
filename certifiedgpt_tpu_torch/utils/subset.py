"""Offline VQAv2 subset generation: a copy of
``certifiedgpt_tpu/utils/subset.py`` for the port (numpy only).

Re-implements the reference's subset utility
(ref ``utils/generate_subset_vqa.py:53-165``): carve K stratified
(by ``question_type``) evaluation subsets of ``subset_size`` annotations
each out of a split, copy the referenced COCO images per subset, and
write sampled annotation/question JSONs. Differences by design: no
sklearn dependency (stratification by per-type round-robin draw from a
seeded shuffle — same marginals), exclusion list optional instead of a
hard-coded path, and questions files are subset too (the reference only
subsets annotations).
"""

from __future__ import annotations

import collections
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np


def stratified_subsets(
    annotations: Sequence[dict],
    subset_size: int,
    num_subsets: int,
    seed: int = 42,
    key: str = "question_type",
) -> List[List[dict]]:
    """Split into ``num_subsets`` disjoint subsets of ``subset_size``,
    each matching the full set's ``question_type`` distribution."""
    rng = np.random.default_rng(seed)
    by_type: Dict[str, List[dict]] = collections.defaultdict(list)
    for ann in annotations:
        by_type[ann.get(key, "unknown")].append(ann)
    for anns in by_type.values():
        rng.shuffle(anns)

    total = len(annotations)
    need = subset_size * num_subsets
    if need > total:
        raise ValueError(
            f"Requested {num_subsets} x {subset_size} but only {total} annotations"
        )

    subsets: List[List[dict]] = [[] for _ in range(num_subsets)]
    cursors = {t: 0 for t in by_type}
    for s in range(num_subsets):
        # proportional allocation with largest-remainder rounding,
        # computed from the REMAINING pools (not the full-set fractions):
        # full-set fractions keep bumping the same small types every
        # round until their pools exhaust, leaving later subsets short of
        # subset_size with no error
        avail = {t: len(anns) - cursors[t] for t, anns in by_type.items()}
        avail_total = sum(avail.values())
        fracs = {
            t: a / avail_total * subset_size for t, a in avail.items()
        }
        counts = {t: min(int(f), avail[t]) for t, f in fracs.items()}
        leftover = subset_size - sum(counts.values())
        for t in sorted(fracs, key=lambda t: fracs[t] - counts[t], reverse=True):
            if leftover <= 0:
                break
            extra = min(leftover, avail[t] - counts[t])
            counts[t] += extra
            leftover -= extra
        assert leftover == 0  # guaranteed by the need<=total check
        for t, count in counts.items():
            start = cursors[t]
            take = by_type[t][start : start + count]
            subsets[s].extend(take)
            cursors[t] = start + len(take)
        assert len(subsets[s]) == subset_size
    return subsets


def generate_subsets(
    annotation_path: str,
    question_path: str,
    images_dir: str,
    output_dir: str,
    split: str = "val",
    subset_size: int = 5000,
    num_subsets: int = 4,
    seed: int = 42,
    copy_images: bool = True,
    exclude_image_ids: Optional[Sequence[int]] = None,
    coco_year: str = "2014",
) -> List[str]:
    """Write ``sample_..._{k}.json`` subset files (+ image dirs).

    Returns the list of written annotation paths.
    """
    with open(annotation_path) as handle:
        ann_file = json.load(handle)
    with open(question_path) as handle:
        q_file = json.load(handle)
    questions_by_id = {q["question_id"]: q for q in q_file.get("questions", [])}

    exclude = set(exclude_image_ids or [])
    usable = []
    for ann in ann_file.get("annotations", []):
        image_id = ann["image_id"]
        if image_id in exclude:
            continue
        file_name = f"COCO_{split}{coco_year}_{image_id:012d}.jpg"
        if os.path.exists(os.path.join(images_dir, file_name)):
            usable.append(ann)

    subsets = stratified_subsets(usable, subset_size, num_subsets, seed)
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for k, subset in enumerate(subsets, start=1):
        if copy_images:
            img_out = os.path.join(output_dir, f"images_{split}_{k}")
            os.makedirs(img_out, exist_ok=True)
            for ann in subset:
                file_name = f"COCO_{split}{coco_year}_{ann['image_id']:012d}.jpg"
                src = os.path.join(images_dir, file_name)
                dst = os.path.join(img_out, file_name)
                if not os.path.exists(dst):
                    shutil.copy(src, dst)

        ann_out = dict(ann_file)
        ann_out["annotations"] = subset
        ann_path = os.path.join(
            output_dir, f"sample_{split}{coco_year}_annotations_{k}.json"
        )
        with open(ann_path, "w") as handle:
            json.dump(ann_out, handle)

        q_out = dict(q_file)
        q_out["questions"] = [
            questions_by_id[a["question_id"]]
            for a in subset
            if a["question_id"] in questions_by_id
        ]
        with open(
            os.path.join(output_dir, f"sample_{split}{coco_year}_questions_{k}.json"),
            "w",
        ) as handle:
            json.dump(q_out, handle)
        written.append(ann_path)
    return written
