"""Shared building blocks (plain functions on tensors) and ``ParamTree``.

Port of ``certifiedgpt_tpu/models/layers.py``. Parameters keep the JAX
layout: dense leaves ``{"kernel": [in, out], "bias": [out]}`` or the int8
``{"kernel_q", "scale"}`` form, norms computed in f32 whatever the
activation dtype, per-layer weights stacked on a leading ``[L, ...]`` axis.
Float products accumulate in f32 and round once to the activation dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from certifiedgpt_tpu_torch.ops import elementwise as E
from certifiedgpt_tpu_torch.ops import quantization as Q


class ParamTree(nn.Module):
    """A nested dict of tensors in the JAX layout; ``tree()`` returns the
    dict that the ``*_apply`` functions take. Frozen (the default), every
    leaf is a buffer, so ``.to(device)`` and ``state_dict`` see it and
    autograd records nothing for it. ``trainable`` makes each floating
    leaf an ``nn.Parameter`` (``requires_grad``), the tensor an optimizer
    updates in place; integer leaves stay buffers."""

    def __init__(self, tree: Mapping[str, Any], trainable: bool = False):
        super().__init__()
        self._names = list(tree)
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value, trainable))
            elif trainable and value.is_floating_point():
                self.register_parameter(name, nn.Parameter(value.detach()))
            else:
                self.register_buffer(name, value)

    def tree(self) -> Dict[str, Any]:
        out = {}
        for name in self._names:
            value = getattr(self, name)
            out[name] = value.tree() if isinstance(value, ParamTree) else value
        return out


def tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_addresses(tree) -> tuple:
    """Where each tensor of a nested dict/list tree lives (address, shape,
    strides, dtype), in a fixed order: a CUDA graph captured over the tree
    replays over exactly these addresses, so a capture is reused only when
    this key is unchanged (an in-place update keeps it, a replaced tensor
    does not)."""
    if isinstance(tree, Mapping):
        return tuple((k, tree_addresses(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(tree_addresses(v) for v in tree)
    return (tree.data_ptr(), tuple(tree.shape), tuple(tree.stride()), tree.dtype)


def layer_slice(stacked: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """Layer ``layer`` of a tree stacked on a leading ``[L, ...]`` axis
    (views, no copies)."""
    return tree_map(lambda a: a[layer], stacked)


def dense(params, x: torch.Tensor, act_quant: bool = False) -> torch.Tensor:
    if "kernel_q" in params and act_quant:
        # W8A8: (xq @ wq) * xs * ws (+ bias), dynamic per-row activation
        # quant; the product, the rescale and the bias are one kernel
        # (w8a8_product)
        return Q.w8a8_matmul(x, params["kernel_q"], params["scale"], params.get("bias"))
    if "kernel_q" in params:
        # weight-only int8: the per-output-channel scale commutes with the
        # contraction and multiplies the f32 result
        out = Q.int8_weight_matmul(x, params["kernel_q"], params["scale"])
    else:
        # f32 accumulation, one rounding to x's dtype (cuBLAS and the CPU
        # kernels accumulate bf16 products in f32, like the JAX einsums'
        # preferred_element_type=float32)
        out = torch.matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        out = out + params["bias"].to(x.dtype)
    return out


def layer_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return E.rms_norm_plain(x, params["scale"], eps)


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    return params["embedding"][ids]


def rotary_tables(
    head_dim: int, max_len: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_len, head_dim] f32 cos/sin tables (HF-LLaMA rotate-half)."""
    return E.make_rotary_tables(head_dim, max_len, theta, device)


def apply_rotary(
    x: torch.Tensor,  # [B, S, H, Dh]
    cos: torch.Tensor,  # [max_len, Dh]
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, S] int
) -> torch.Tensor:
    return E.apply_rotary_plain(x, cos, sin, positions)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in f32 and rounded to x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def ln_dense(params, x: torch.Tensor, ln_params, eps: float = 1e-6,
             act_quant: bool = False) -> torch.Tensor:
    """``dense(params, layer_norm(ln_params, x))``; on the W8A8 path the LN
    and the activation quant are one kernel (``ops.quantization.ln_quant_rows``)."""
    if "kernel_q" in params and act_quant:
        xq, xs = Q.ln_quant_rows(x, ln_params["scale"], ln_params["bias"], eps)
        return Q._w8a8_epilogue(xq, xs, params["kernel_q"], params["scale"], x.dtype,
                                params.get("bias"))
    return dense(params, layer_norm(ln_params, x, eps), act_quant=act_quant)


def dense_quantized(params, xq: torch.Tensor, xs: torch.Tensor, dtype) -> torch.Tensor:
    """``dense(params, x, act_quant=True)`` of rows already quantized
    (``xq, xs = quantize_rows(x)``), for products that share an input: the
    codes and scales are the same whichever product quantizes them."""
    return Q._w8a8_epilogue(xq, xs, params["kernel_q"], params["scale"], dtype,
                            params.get("bias"))


def gelu_dense(params, x: torch.Tensor, act_quant: bool = False) -> torch.Tensor:
    """``dense(params, gelu(x))``; on the W8A8 path the GELU and the
    activation quant are one kernel (``ops.quantization.gelu_quant_rows``)."""
    if "kernel_q" in params and act_quant:
        return Q.w8a8_gelu_matmul(x, params["kernel_q"], params["scale"], params.get("bias"))
    return dense(params, gelu(x), act_quant=act_quant)
