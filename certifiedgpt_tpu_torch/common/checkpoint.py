"""Checkpoint restore (the read side of the JAX package's ``.npz`` format).

A checkpoint is one ``.npz`` of path-flattened arrays plus a JSON metadata
sidecar (``{path}.meta.json``), as ``certifiedgpt_tpu/common/checkpoint.py``
writes it: the trainable parameters under ``model:`` + the ``/``-joined
dict path (``model:llama_proj/kernel``). ``load_checkpoint`` fills a
template dict of tensors from it, each array cast to its template tensor's
dtype and device. Writing checkpoints, and the optimizer state stored under
``opt:``, belong to training, which the port does not have yet (ROADMAP.md,
modules item 14).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], path: Tuple[str, ...]) -> Any:
    if isinstance(template, Mapping):
        return {k: _unflatten_into(v, flat, path + (str(k),)) for k, v in template.items()}
    key = "model:" + "/".join(path)
    if key not in flat:
        raise KeyError(f"Checkpoint missing array for '{key}'")
    arr = flat[key]
    if arr.shape != tuple(template.shape):
        raise ValueError(
            f"Shape mismatch for '{key}': ckpt {arr.shape} vs model {tuple(template.shape)}")
    return torch.from_numpy(arr).to(device=template.device, dtype=template.dtype)


def load_checkpoint(path: str, trainable_template: Mapping[str, Any]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore (trainable, metadata) from ``path`` into the shapes, dtypes
    and devices of ``trainable_template``. A missing file raises
    (``np.load``), as does a missing key or a shape that differs."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    trainable = _unflatten_into(trainable_template, flat, ())
    metadata: Dict[str, Any] = {}
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path, "r") as handle:
            metadata = json.load(handle)
    return trainable, metadata
