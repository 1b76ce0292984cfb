"""Carry a JAX-package parameter tree across to the port.

``params_from_jax`` takes the JAX package's MiniGPT-4 parameter pytree as
numpy arrays (``jax.device_get`` of it, or a loaded ``.npz``) and returns
the port's tree: same nesting, same layout, torch tensors on ``device``.
bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which torch
cannot wrap: they go through f32 and back to ``torch.bfloat16`` (exact).
int8 and f32 leaves go across as they are; on CUDA the int8 kernels are
stored column-major (``ops.quantization.int8_kernel_layout``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from certifiedgpt_tpu_torch.models.minigpt4 import MiniGPT4Config
from certifiedgpt_tpu_torch.ops.quantization import int8_kernel_layout


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        out = {k: _convert(v, device) for k, v in tree.items()}
        if "kernel_q" in out and out["kernel_q"].device.type == "cuda":
            out["kernel_q"] = int8_kernel_layout(out["kernel_q"])
        return out
    return tensor_from_numpy(tree, device)


def _expect(tree, path, shape):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise ValueError(f"parameter tree has no {'/'.join(path)}")
        node = node[key]
    if tuple(np.shape(node)) != tuple(shape):
        raise ValueError(
            f"{'/'.join(path)} has shape {tuple(np.shape(node))}, the config "
            f"expects {tuple(shape)}"
        )


def params_from_jax(tree: Mapping[str, Any], cfg: MiniGPT4Config, device="cuda"):
    """The port's MiniGPT-4 parameter tree from the JAX package's, after
    checking a few leaves against ``cfg``'s widths."""
    v, q, lc = cfg.vit, cfg.qformer, cfg.llama
    _expect(tree, ("vit", "patch_embed", "kernel"),
            (v.in_channels * v.patch_size ** 2, v.embed_dim))
    _expect(tree, ("vit", "pos_embed"), (1, v.seq_len, v.embed_dim))
    _expect(tree, ("qformer", "query_tokens"), (1, q.num_query_tokens, q.hidden_size))
    _expect(tree, ("llama_proj", "kernel"), (q.hidden_size, lc.hidden_size))
    _expect(tree, ("llama", "embed_tokens", "embedding"), (lc.vocab_size, lc.hidden_size))
    return _convert(tree, torch.device(device))
