"""The port's dataset tools (``utils/subset.py``, ``utils/dataset_stats.py``)
against the JAX package's on the same inputs: the four cases of
``tests/test_utils.py``, each output equal to the JAX function's (the
subsets' annotations and the written files exactly, the statistics within
1e-7)."""

import json
import os

import numpy as np
from PIL import Image

from certifiedgpt_tpu.utils import dataset_stats as JSTATS
from certifiedgpt_tpu.utils import subset as JSUB
from certifiedgpt_tpu_torch.utils import dataset_stats as TSTATS
from certifiedgpt_tpu_torch.utils import subset as TSUB


def test_stratified_subsets_disjoint_and_proportional():
    annotations = [{"question_id": i, "question_type": t} for i, t in enumerate(
        ["what"] * 600 + ["is the"] * 300 + ["how many"] * 100)]
    got = TSUB.stratified_subsets([dict(a) for a in annotations], 100, 3)
    want = JSUB.stratified_subsets([dict(a) for a in annotations], 100, 3)
    assert got == want
    ids = [a["question_id"] for s in got for a in s]
    assert all(len(s) == 100 for s in got) and len(ids) == len(set(ids))


def test_stratified_subsets_exact_size_with_skewed_types():
    annotations = ([{"question_type": "A", "question_id": i} for i in range(3)]
                   + [{"question_type": "B", "question_id": 100 + i} for i in range(97)])
    got = TSUB.stratified_subsets([dict(a) for a in annotations], 50, 2, seed=0)
    want = JSUB.stratified_subsets([dict(a) for a in annotations], 50, 2, seed=0)
    assert got == want and [len(s) for s in got] == [50, 50]


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_generate_subsets_end_to_end(tmp_path):
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    annotations, questions = [], []
    for i in range(40):
        image_id = 5000 + i
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)).save(
            img_dir / f"COCO_val2014_{image_id:012d}.jpg")
        annotations.append({"question_id": i, "image_id": image_id,
                            "question_type": "what" if i % 2 == 0 else "is the", "answers": []})
        questions.append({"question_id": i, "image_id": image_id, "question": f"q{i}"})
    (tmp_path / "ann.json").write_text(json.dumps({"annotations": annotations, "info": "x"}))
    (tmp_path / "q.json").write_text(json.dumps({"questions": questions}))
    args = (str(tmp_path / "ann.json"), str(tmp_path / "q.json"), str(img_dir))
    got = TSUB.generate_subsets(*args, str(tmp_path / "torch"), split="val", subset_size=10,
                                num_subsets=2)
    want = JSUB.generate_subsets(*args, str(tmp_path / "jax"), split="val", subset_size=10,
                                 num_subsets=2)
    assert [os.path.relpath(p, tmp_path / "torch") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    got_files, want_files = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert got_files == want_files and len(got_files) == 2 * (10 + 2)


def test_compute_mean_std(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            tmp_path / f"img_{i}.png")
    got = TSTATS.compute_mean_std(str(tmp_path), image_size=16)
    want = JSTATS.compute_mean_std(str(tmp_path), image_size=16)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
