"""The decoder's tensor-parallel collectives (Megatron layout).

The JAX package shards the decoder's parameters (``parallel/mesh.py``
``llama_param_spec``) and GSPMD inserts the collectives. Here each rank
holds its shard (``mesh.partition_llama``) and ``models/llama.py`` calls
these functions whenever the active mesh's model group has more than one
rank:

- ``copy_to_model``: the input of the column-split products (q/k/v,
  gate/up, lm_head). Identity forward; the backward sums the gradient over
  the model group (each rank's heads give a part of it).
- ``row_parallel_dense``: the row-split products (o_proj, down_proj). The
  partial products are summed *before* the single rounding: the int32 (f32
  on the CPU) accumulator of W8A8 (``int8_accumulate``, then the rescale
  ``w8a8_epilogue``, the one-process product's arithmetic), the f32
  product of the weight-only int8 and float kernels, then the scale and
  the cast, so the split adds no rounding that one process lacks. Its W8A8 input is split across the
  ranks, and per-row quantization needs the whole row's max: a MAX over the
  model group comes first. The backward is the one-process product's on
  this rank's rows of the weight (identity through the sum); a trainable
  float weight (``run.trainable_keys: [llama]``) gets its rows' gradient,
  ``x^T g``, from this rank's part of x.
- ``vocab_parallel_embed``: a masked lookup in this rank's rows of the
  table, then a sum over the model group.
- ``gather_from_model``: this rank's vocabulary columns of the logits,
  gathered whole before argmax, top-p, the penalty or the loss; the
  backward keeps this rank's columns.

The decoder takes these paths only when the model group has more than one
rank (``tensor_parallel``): in a group of one every collective would be the
identity, and on the card each NCCL call still costs a launch and a wait
between streams (with them, a data-parallel certified image at world size 1
on one H100 ran 3-15 % slower than a plain one;
``scripts/bench_torch_distributed.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from certifiedgpt_tpu_torch.ops import quantization as Q
from certifiedgpt_tpu_torch.parallel.mesh import ProcessMesh, active_mesh


def tensor_parallel() -> Optional[ProcessMesh]:
    """The active mesh when its model group has more than one rank, else
    None."""
    mesh = active_mesh()
    if mesh is None or mesh.model_group is None or mesh.n_model == 1:
        return None
    return mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


def copy_to_model(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.n_model)]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g.chunk(mesh.n_model, dim=-1)[mesh.model_index].contiguous(), None


def gather_from_model(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``x [..., V / n_model]`` of every rank of the model group,
    concatenated on the last dim in model-index order."""
    return _GatherFromModel.apply(x, mesh)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor, mesh: ProcessMesh
                         ) -> torch.Tensor:
    """Rows ``ids`` of the whole table from this rank's ``[V / n, D]``
    block (rows ``model_index * V / n`` on): ids outside it give zeros, and
    the sum over the model group fills them. Exact: one term is nonzero."""
    rows = table.shape[0]
    local = ids - mesh.model_index * rows
    valid = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)]
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    dist.all_reduce(out, group=mesh.model_group)
    return out


def f32_product(x2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x2 [M, K] @ weight [K, N]`` as f32, not rounded to x's dtype. On
    CUDA a bf16/f16 ``x2`` keeps the one-process product's operands (the
    weight cast to x's dtype) with an f32 output; elsewhere the operands
    are cast to f32, which is exact for them."""
    if x2.device.type == "cuda" and x2.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x2, weight.to(x2.dtype), out_dtype=torch.float32)
    return x2.float() @ weight.float()


class _RowParallelDense(torch.autograd.Function):
    """``x [..., in / n] @ weight [in / n, out]`` summed over the model
    group; ``scale`` (int8 kernels) is the whole ``[out]`` channel scale."""

    @staticmethod
    def forward(ctx, x, weight, scale, act_quant, mesh):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        # x only for the gradient of a trainable float weight
        ctx.save_for_backward(weight, scale, x2 if weight.requires_grad else None)
        ctx.x_dtype, ctx.act_quant = x.dtype, act_quant
        group = mesh.model_group
        if scale is not None and act_quant:
            xq, xs = Q.quantize_rows(
                x2, lambda amax: dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group))
            acc = Q.int8_accumulate(xq, weight)
            dist.all_reduce(acc, group=group)
            return Q.w8a8_epilogue(acc, xs, scale, None, x.dtype).reshape(*lead, -1)
        acc = f32_product(x2, weight)
        dist.all_reduce(acc, group=group)
        out = acc * scale if scale is not None else acc
        return out.to(x.dtype).reshape(*lead, -1)

    @staticmethod
    def backward(ctx, g):
        weight, scale, x2 = ctx.saved_tensors
        if scale is not None and ctx.act_quant:
            gx = Q._grad_input(g, weight, scale, ctx.x_dtype)
        elif scale is not None:
            gx = Q.int8_weight_grad(g, weight, scale, ctx.x_dtype)
        else:
            gx = torch.matmul(g, weight.to(g.dtype).t()).to(ctx.x_dtype)
        gw = None
        if x2 is not None:  # the one-process product's: x^T g in x's dtype
            g2 = g.reshape(-1, g.shape[-1]).to(x2.dtype)
            gw = torch.matmul(x2.t(), g2).to(weight.dtype)
        return gx, gw, None, None, None


def row_parallel_dense(params, x: torch.Tensor, mesh: ProcessMesh,
                       act_quant: bool = False) -> torch.Tensor:
    """``models.layers.dense`` of a row-split leaf (``o_proj``,
    ``down_proj``) summed over the model group."""
    if "kernel_q" in params:
        out = _RowParallelDense.apply(x, params["kernel_q"], params["scale"], act_quant, mesh)
    else:
        out = _RowParallelDense.apply(x, params["kernel"], None, False, mesh)
    if "bias" in params:
        out = out + params["bias"].to(x.dtype)
    return out
