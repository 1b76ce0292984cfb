"""GPipe pipeline parallelism of the decoder's training forward over
``torch.distributed``.

Port of ``certifiedgpt_tpu/parallel/pipeline.py``. The decoder's layers
live as one stacked ``[L, ...]`` tree, so a stage is a block of the leading
axis: ``partition_llama_pipeline`` keeps this rank's ``L/P`` contiguous
blocks (``mesh.pipe_index`` of the ``pipe`` axis, ``parallel/mesh.py``).
``pipeline_llama_apply`` runs the decoder's no-cache forward through the
stages; ``pipeline_minigpt4_loss`` is ``minigpt4_loss`` with the decoder
so pipelined. The vision tower, the Q-Former, the projection and the
embedding run before the pipeline and the final norm, ``lm_head`` and the
loss after it, replicated on every stage, as in the JAX package.

The schedule (``_Schedule``): the batch splits into ``n_micro``
microbatches; over the ticks ``t = 0 .. M+P-2`` stage ``idx`` holds
microbatch ``k = t - idx`` when ``0 <= k < M`` and idles otherwise (the
JAX loop computes garbage there that it never selects). Stage 0 reads its
microbatch from the input, a later stage receives it from ``idx - 1``,
runs its blocks and passes the result on. At each tick a stage posts its
receive and the send of the previous tick's output together
(``dist.batch_isend_irecv``) and waits for both, so no blocking send ever
waits on a receive around the ring. The last stage's outputs are then
broadcast over the pipe group (the JAX masked ``psum``: no float changes).

The JAX module needs no backward: ``ppermute`` transposes under AD. Here
the reverse schedule is written out, in the same ``autograd.Function``:
each stage kept every microbatch's (input, output) graph of its blocks;
the reverse ticks run from ``M+P-2`` down, stage ``P-1`` taking microbatch
``k``'s gradient from its own ``grad_output`` (every rank holds the same
one: the loss after the pipeline is replicated, so it is never summed over
the stages, which would give P times the gradient), a stage before it
receiving the gradient of its output from ``idx + 1``. A stage
differentiates its graph for the input and for its trainable layer leaves
(``run.trainable_keys: [llama]``; summed over the microbatches) and sends
the input's gradient to ``idx - 1``. Stage 0's input gradients are
broadcast over the pipe group, so the replicated leaves upstream
(``llama_proj``) get the same gradient on every stage.

At one stage (``n_pipe == 1``, or no mesh) nothing is sent: the microbatch
loop and the saved-graph backward run alone, which is what one card runs.
Per-layer remat is the sequential decoder's (``models/llama.py``
``_run_layers`` under ``remat_policy``); ``remat_every`` > 1 is refused, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.models.llama import (
    LlamaConfig,
    TrainingMask,
    _run_layers,
    cross_entropy_loss,
    lm_head_logits,
)
from certifiedgpt_tpu_torch.models.minigpt4 import decoder_inputs
from certifiedgpt_tpu_torch.ops import elementwise as E
from certifiedgpt_tpu_torch.optim import flatten_tree
from certifiedgpt_tpu_torch.parallel.mesh import ProcessMesh, own_storage

def n_stages(mesh: Optional[ProcessMesh]) -> int:
    return 1 if mesh is None else mesh.n_pipe


def _stage_block(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This stage's contiguous block of the leading axis of ``x``."""
    if x.shape[0] % mesh.n_pipe:
        raise ValueError(f"a leaf of {x.shape[0]} stacked layers does not divide into "
                         f"pipe={mesh.n_pipe} stages")
    return own_storage(x.chunk(mesh.n_pipe, dim=0)[mesh.pipe_index], x)


def partition_llama_pipeline(llama_params: Dict[str, Any], mesh: ProcessMesh
                             ) -> Dict[str, Any]:
    """This rank's stage of the decoder: its ``L/P`` blocks of every stacked
    ``layers`` leaf (``scale [L, out]`` and ``kernel_q [L, in, out]``
    together), each in storage of its own and in its leaf's layout;
    ``embed_tokens``, ``norm`` and ``lm_head`` whole."""
    if n_stages(mesh) == 1:
        return llama_params
    return {top: L.tree_map(lambda x: _stage_block(x, mesh), sub) if top == "layers" else sub
            for top, sub in llama_params.items()}


def stage_decoder(model, mesh: ProcessMesh) -> None:
    """Keep this rank's stage of a ``MiniGPT4Model``'s decoder in place of
    the whole stack (``run.pipeline_parallel``; the JAX agent's
    ``_shard_model_params_pipeline`` checks)."""
    params = model.params
    if "llama" not in params:
        raise ValueError("run.pipeline_parallel applies to the LLaMA decoder tower; this "
                         "model has no 'llama' params to stage")
    layers = model.cfg.llama.num_layers
    if layers % mesh.n_pipe:
        raise ValueError(f"model.num_layers={layers} does not divide into "
                         f"pipeline_parallel={mesh.n_pipe} stages")
    model.module.llama.params = L.ParamTree(partition_llama_pipeline(params["llama"], mesh))


# --- the schedule ----------------------------------------------------------
class _Schedule:
    """The forward and the reverse ticks of one pipelined call on this
    rank (module docstring). ``stage(x, k)`` runs this stage's blocks on
    microbatch ``k``; ``leaves`` are its layer leaves that take a
    gradient."""

    def __init__(self, stage, mesh: Optional[ProcessMesh], n_micro: int,
                 leaves: List[torch.Tensor]):
        self.stage, self.mesh, self.m, self.leaves = stage, mesh, n_micro, leaves
        self.p = n_stages(mesh)
        self.idx = 0 if self.p == 1 else mesh.pipe_index
        self.saved: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = []

    def _exchange(self, recv_from: Optional[int], like: torch.Tensor,
                  send: Optional[torch.Tensor], send_to: int) -> Optional[torch.Tensor]:
        """Post the receive from stage ``recv_from`` (a tensor like
        ``like``) and the send of ``send`` to stage ``send_to`` together,
        wait for both; returns what was received."""
        ops, buf = [], None
        if recv_from is not None:
            buf = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, buf, self.mesh.stage_rank(recv_from),
                                  group=self.mesh.pipe_group))
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), self.mesh.stage_rank(send_to),
                                  group=self.mesh.pipe_group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return buf

    def _broadcast(self, x: Optional[torch.Tensor], like: torch.Tensor, stage: int
                   ) -> torch.Tensor:
        """``x`` of stage ``stage`` on every stage of the pipeline."""
        if self.p == 1:
            return x
        if x is None:
            x = torch.empty_like(like)
        dist.broadcast(x, self.mesh.stage_rank(stage), group=self.mesh.pipe_group)
        return x

    def forward(self, x: torch.Tensor, keep_graphs: bool) -> torch.Tensor:
        p, idx, m = self.p, self.idx, self.m
        xs = x.chunk(m)
        outs: List[torch.Tensor] = []
        sent = None  # the output of the last tick, to send on
        for t in range(m + p - 1):
            k = t - idx
            recv = self._exchange(idx - 1 if idx > 0 and 0 <= k < m else None, xs[0],
                                  sent if idx < p - 1 else None, idx + 1)
            sent = None
            if not 0 <= k < m:
                continue
            inp = xs[k] if idx == 0 else recv
            if keep_graphs:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = self.stage(inp, k)
                self.saved.append((inp, out))
                out = out.detach()
            else:
                out = self.stage(inp, k)
            if idx == p - 1:
                outs.append(out)
            else:
                sent = out
        return self._broadcast(torch.cat(outs) if outs else None, x, p - 1)

    def backward(self, grad: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        p, idx, m = self.p, self.idx, self.m
        grads = grad.chunk(m)
        grad_in: List[torch.Tensor] = []
        leaf_grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        sent = None  # the input gradient of the last reverse tick, to send back
        for t in reversed(range(m + p - 1)):
            k = t - idx
            recv = self._exchange(idx + 1 if idx < p - 1 and 0 <= k < m else None, grads[0],
                                  sent if idx > 0 else None, idx - 1)
            sent = None
            if not 0 <= k < m:
                continue
            inp, out = self.saved[k]
            self.saved[k] = None  # the graph goes with its backward
            g = grads[k] if idx == p - 1 else recv
            got = torch.autograd.grad(out, [inp, *self.leaves], g, allow_unused=True)
            for i, lg in enumerate(got[1:]):
                if lg is not None:
                    leaf_grads[i] = lg if leaf_grads[i] is None else leaf_grads[i] + lg
            if idx == 0:
                grad_in.insert(0, got[0])
            else:
                sent = got[0]
        grad_x = self._broadcast(torch.cat(grad_in) if grad_in else None, grad, 0)
        return (grad_x, *leaf_grads)


class _Pipeline(torch.autograd.Function):
    """The schedule as one function of the replicated input and this
    stage's trainable layer leaves: replicated in, replicated out."""

    @staticmethod
    def forward(ctx, schedule: _Schedule, x: torch.Tensor, *leaves: torch.Tensor):
        ctx.schedule = schedule
        return schedule.forward(x, keep_graphs=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        schedule = ctx.schedule
        del ctx.schedule
        return (None, *schedule.backward(grad))


def pipeline_llama_apply(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D]: this rank's rows (its data block)
    attention_mask: torch.Tensor,  # [B, S] 1 = valid
    positions: torch.Tensor,  # [B, S]
    mesh: Optional[ProcessMesh],
    n_micro: int,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] packed-segment ids
    compute_logits: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The decoder's training forward (``llama_apply`` without a cache,
    packed ``segment_ids`` included), GPipe-pipelined over the mesh's
    ``pipe`` axis in ``n_micro`` microbatches; ``params`` holds this
    stage's blocks (``partition_llama_pipeline``). Under a ``data`` axis
    each rank passes its rows of the batch. Returns ``(logits or None,
    final hidden)``."""
    n_pipe = n_stages(mesh)
    n_data = 1 if mesh is None else mesh.shape["data"]
    rows = inputs_embeds.shape[0]
    b = rows * n_data  # the whole batch's rows, as the JAX function sees them
    if cfg.num_layers % n_pipe:
        raise ValueError(f"num_layers={cfg.num_layers} does not divide into pipe={n_pipe} "
                         "stages")
    if b % n_micro:
        raise ValueError(f"batch={b} does not divide into n_micro={n_micro} microbatches")
    if cfg.remat and cfg.remat_every != 1:
        raise ValueError(
            "the pipelined forward supports per-layer remat only (remat_every=1); the "
            "full-scale sweep rejected every-k checkpointing anyway (docs/DESIGN.md)")
    mb = b // n_micro
    if mb % n_data:
        raise ValueError(f"microbatch={mb} rows do not divide over the data axis ({n_data}); "
                         "lower n_micro or the data-parallel degree")
    local = cfg.num_layers // n_pipe
    layer_leaves = [leaf for _, leaf in flatten_tree(params["layers"])]
    held = {leaf.shape[0] for leaf in layer_leaves}
    if held != {local}:
        raise ValueError(f"the layer stack holds {sorted(held)} blocks, but a stage of "
                         f"pipe={n_pipe} runs {local} (partition_llama_pipeline)")

    device = inputs_embeds.device
    cos, sin = E.rotary_tables(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta,
                               device=device)
    mask = TrainingMask(attention_mask, segment_ids)
    stage_cfg = dataclasses.replace(cfg, num_layers=local)
    per = rows // n_micro

    def stage(x, k):
        at = slice(k * per, (k + 1) * per)
        x, y = _run_layers(params, stage_cfg, x, cos, sin, positions[at], mask.rows(at))
        return x + y  # the stage's last residual add: the next stage starts a stream

    x = inputs_embeds.to(cfg.dtype)
    leaves = [leaf for leaf in layer_leaves if leaf.requires_grad]
    schedule = _Schedule(stage, mesh, n_micro, leaves)
    if torch.is_grad_enabled() and (x.requires_grad or leaves):
        x = _Pipeline.apply(schedule, x, *leaves)
    else:
        x = schedule.forward(x, keep_graphs=False)
    _, x = E.residual_norm(x, None, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = lm_head_logits(params, x) if compute_logits else None
    return logits, x


def pipeline_minigpt4_loss(params: Dict[str, Any], cfg, batch: Dict[str, torch.Tensor],
                           mesh: Optional[ProcessMesh], n_micro: int,
                           reduction: str = "mean") -> torch.Tensor:
    """``models/minigpt4.minigpt4_loss`` with the decoder pipelined over the
    mesh's ``pipe`` axis: the same supervision, packed or unpacked, and the
    same ``reduction`` (``mean``, ``sum``, ``none``). The towers before the
    decoder and the loss after it run replicated on every stage."""
    embeds, positions, segment_ids = decoder_inputs(params, cfg, batch)
    logits, _ = pipeline_llama_apply(params["llama"], cfg.llama, embeds,
                                     batch["attention_mask"], positions, mesh, n_micro,
                                     segment_ids=segment_ids)
    return cross_entropy_loss(logits, batch["labels"], cfg.label_smoothing,
                              reduction=reduction)
