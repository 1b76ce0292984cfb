"""Checkpoints in the JAX package's ``.npz`` format, written and read.

A checkpoint is one ``.npz`` of path-flattened arrays plus a JSON metadata
sidecar (``{path}.meta.json``), as ``certifiedgpt_tpu/common/checkpoint.py``
writes it: the trainable parameters under ``model:`` + the ``/``-joined
dict path (``model:llama_proj/kernel``), the optimizer state under ``opt:``
+ the path of the optax state (``optim.AdamW.state_arrays``). So a
projection the port trains is a ``model.vqa_finetuned`` that both packages'
agents read, and either package resumes the other's run.

``save_checkpoint`` writes the ``.npz`` and then the sidecar, each to a
temporary file renamed into place, so a crash leaves no torn file.
``load_checkpoint`` fills a template dict of tensors, each array cast to
its template tensor's dtype and device; ``load_opt_state`` reads the
``opt:`` arrays. bf16 tensors are written as f32 (exact), which both
packages' readers cast back to the template's dtype.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

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
    return array_to_tensor(arr, template)


def array_to_tensor(arr, like: torch.Tensor) -> torch.Tensor:
    """A checkpoint array as a tensor of ``like``'s dtype and device. A
    bf16 array that the JAX package wrote (numpy stores it as two opaque
    bytes) is read as the upper half of an f32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device=like.device, dtype=like.dtype)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as the array a checkpoint stores: a host copy, bf16 as f32
    (exact; numpy has no bf16)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "/"))
        else:
            flat[name] = tensor_to_array(value)
    return flat


def _write_atomic(path: str, write) -> None:
    """``write(handle)`` into a temporary file beside ``path``, renamed
    onto ``path`` when it is complete."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as handle:
            write(handle)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(path: str, trainable: Mapping[str, Any],
                    opt_state: Optional[Mapping[str, np.ndarray]] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write the trainable tree (under ``model:``), the optimizer state's
    arrays (``AdamW.state_arrays``, under ``opt:``) and the metadata
    sidecar, each atomically."""
    flat = _flatten(trainable, "model:")
    if opt_state is not None:
        flat.update({f"opt:{k}": np.asarray(v) for k, v in opt_state.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_atomic(path, lambda handle: np.savez(handle, **flat))
    _write_atomic(path + ".meta.json",
                  lambda handle: handle.write(json.dumps(metadata or {}).encode()))


def load_checkpoint(path: str, trainable_template: Mapping[str, Any]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore (trainable, metadata) from ``path`` into the shapes, dtypes
    and devices of ``trainable_template``. A missing file raises
    (``np.load``), as does a missing key or a shape that differs."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k.startswith("model:")}
    trainable = _unflatten_into(trainable_template, flat, ())
    metadata: Dict[str, Any] = {}
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path, "r") as handle:
            metadata = json.load(handle)
    return trainable, metadata


def load_opt_state(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The optimizer state's arrays of a checkpoint (keys without their
    ``opt:`` prefix), or None when it holds none (a ``_best`` file)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k[len("opt:"):]: data[k] for k in data.files if k.startswith("opt:")}
    return flat or None
