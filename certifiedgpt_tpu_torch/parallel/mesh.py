"""The process mesh: data, tensor and pipeline parallelism over
``torch.distributed``.

Port of ``certifiedgpt_tpu/parallel/mesh.py``. The JAX package runs one
controller process over a device mesh and lets XLA insert the collectives;
here every rank is a process of its own (one card each, or a gloo process
on the CPU) and the collectives are written out.

The ranks form a grid ``(dcn, data, model)`` with ``model`` innermost, so
the ranks of one model group are contiguous (the JAX ``make_mesh`` keeps
the ``model`` axis inside a slice for the same reason: its collectives run
every layer). Rank ``r`` sits at ``model = r % n_model``, ``data = (r //
n_model) % n_data``, ``dcn = r // (n_model * n_data)``.

- The **batch group** of a rank holds the ranks with its model index: the
  batch (and the Monte-Carlo axis of certification) splits over it, in the
  order of ``batch_index = dcn * n_data + data``; ``batch_divisor`` is its
  size (dcn x data).
- The **model group** holds the ranks with its batch index: the decoder's
  tensor-parallel shards (``partition_llama``, Megatron layout) live on it.

``pipeline_parallel`` > 1 adds a ``pipe`` axis outside the others, so the
grid is ``(pipe, data, model)`` and a stage is a contiguous block of ranks,
as the JAX ``make_mesh`` keeps stages on neighbouring devices: rank ``r``
sits at ``pipe = r // (n_data * n_model)`` and at the data and model index
of ``r % (n_data * n_model)``. The batch group then holds the ranks of its
stage with its model index, so the batch splits over ``data`` only and the
stages of one pipeline see the same rows (``P("data")`` in JAX). The
**pipe group** holds the ranks with its data and model index: the stages
of one pipeline (``parallel/pipeline.py``). A pipe axis excludes a ``dcn``
axis, as in the JAX package.

``dcn_parallel`` 0 or absent means 1: GPUs carry no ``slice_index``, so the
JAX ``detect_num_slices`` has no counterpart, and a ``dcn`` axis is only an
outer batch axis here.

Without ``torch.distributed`` initialized the mesh is one process and has
no groups: every collective below returns its input. Once it is
initialized, the groups exist even at world size 1, so the data-parallel
code paths (the token gather of certification, the gradient sum of
training) run there as at any size.

The tensor-parallel decoder reads the *active* mesh (``set_active_mesh``;
the agents set theirs), as Megatron reads its process-global parallel
state: the decoder's functions keep their signatures. It splits only when
the model group has more than one rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from certifiedgpt_tpu_torch.models.layers import ParamTree
from certifiedgpt_tpu_torch.ops.quantization import int8_kernel_layout


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def barrier() -> None:
    """Wait for every rank (nothing without a default group)."""
    if distributed():
        dist.barrier()


class ProcessMesh:
    """One rank's place in the ``(dcn, data, model)`` grid, or the
    ``(pipe, data, model)`` grid, with its batch, model and pipe groups
    (None without ``torch.distributed``; no pipe group at one stage)."""

    def __init__(self, n_dcn: int, n_data: int, n_model: int, rank: int = 0,
                 n_pipe: int = 1):
        self.shape = {"pipe": int(n_pipe), "dcn": int(n_dcn), "data": int(n_data),
                      "model": int(n_model)}
        self.rank = int(rank)
        self.stage_size = n_dcn * n_data * n_model
        self.pipe_index = rank // self.stage_size
        local = rank % self.stage_size
        self.model_index = local % n_model
        self.data_index = (local // n_model) % n_data
        self.dcn_index = local // (n_model * n_data)
        self.batch_index = self.dcn_index * n_data + self.data_index
        self.model_group = None
        self.batch_group = None
        self.pipe_group = None

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def n_pipe(self) -> int:
        return self.shape["pipe"]

    @property
    def batch_divisor(self) -> int:
        return self.shape["dcn"] * self.shape["data"]

    @property
    def splits_decoder(self) -> bool:
        """Whether this rank holds a part of some decoder leaves: its
        stage's blocks (pipe group) or its tensor-parallel shards."""
        return self.pipe_group is not None or (self.model_group is not None
                                               and self.n_model > 1)

    def stage_rank(self, stage: int) -> int:
        """The global rank of stage ``stage`` of this rank's pipeline."""
        return stage * self.stage_size + self.rank % self.stage_size

    # --- data parallelism ------------------------------------------------
    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of the rows of ``x`` (dim 0 split
        over the batch group in batch-index order)."""
        per = x.shape[0] // self.batch_divisor
        return x[self.batch_index * per:(self.batch_index + 1) * per]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every rank of the batch group, concatenated in
        batch-index order (``local_rows``' inverse)."""
        if self.batch_group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.batch_divisor)]
        dist.all_gather(parts, x.contiguous(), group=self.batch_group)
        return torch.cat(parts, dim=0)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch group, in place."""
        if self.batch_group is not None:
            dist.all_reduce(x, group=self.batch_group)
        return x


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_dcn: Optional[int] = 1,
              n_pipe: int = 1) -> ProcessMesh:
    """The mesh of this process: ``n_pipe`` stages (or ``n_dcn``, 0 or None:
    1) x ``n_data`` (None: what the world size leaves) x ``n_model`` ranks,
    which must be the world size. Builds the batch, model and pipe groups
    when ``torch.distributed`` is initialized (every rank builds every
    group, in one order, as ``new_group`` requires)."""
    n_dcn = int(n_dcn or 1)
    n_model = int(n_model or 1)
    n_pipe = int(n_pipe or 1)
    world, rank = process_count(), process_index()
    if n_pipe > 1:
        # the JAX make_mesh's refusals, in its words
        if n_dcn > 1:
            raise ValueError(
                "pipeline_parallel across DCN slices is not supported: per-tick activation "
                "transfers must ride ICI, not the 10x-slower DCN (pick one of "
                "dcn_parallel/pipeline_parallel)")
        if world % n_pipe:
            raise ValueError(f"{world} devices do not divide into pipeline_parallel={n_pipe} "
                             "stages")
        if (world // n_pipe) % n_model:
            raise ValueError(f"{world // n_pipe} devices per pipeline stage do not divide "
                             f"into model_parallel={n_model}")
    if n_data is None:
        if world % (n_pipe * n_dcn * n_model):
            raise ValueError(
                f"{world} processes do not divide into dcn_parallel={n_dcn} x "
                f"model_parallel={n_model}; pick divisors of the world size"
            )
        n_data = world // (n_pipe * n_dcn * n_model)
    if n_pipe * n_dcn * n_data * n_model != world:
        outer = f"pipe={n_pipe}" if n_pipe > 1 else f"dcn={n_dcn}"
        raise ValueError(
            f"the mesh {outer} x data={n_data} x model={n_model} = "
            f"{n_pipe * n_dcn * n_data * n_model} ranks, but the world size is {world} "
            "(run.distributed with one process per rank, e.g. torch.distributed.run "
            "--nproc_per_node)"
        )
    mesh = ProcessMesh(n_dcn, n_data, n_model, rank, n_pipe)
    if distributed():
        n_batch, stage = n_dcn * n_data, mesh.stage_size
        for p in range(n_pipe):
            for b in range(n_batch):
                group = dist.new_group([p * stage + b * n_model + m for m in range(n_model)])
                if (p, b) == (mesh.pipe_index, mesh.batch_index):
                    mesh.model_group = group
        for p in range(n_pipe):
            for m in range(n_model):
                group = dist.new_group([p * stage + b * n_model + m for b in range(n_batch)])
                if (p, m) == (mesh.pipe_index, mesh.model_index):
                    mesh.batch_group = group
        if n_pipe > 1:
            for b in range(n_batch):
                for m in range(n_model):
                    group = dist.new_group([p * stage + b * n_model + m for p in range(n_pipe)])
                    if (b, m) == (mesh.batch_index, mesh.model_index):
                        mesh.pipe_group = group
            # NCCL wants every rank of a group in its first point-to-point
            # call, which the schedule's first ticks are not: a collective
            # sets the group up first
            dist.barrier(group=mesh.pipe_group)
    return mesh


def batch_divisor(mesh: Optional[ProcessMesh]) -> int:
    """Ranks the batch/MC dimension splits over (dcn x data)."""
    return 1 if mesh is None else mesh.batch_divisor


_ACTIVE: Optional[ProcessMesh] = None


def set_active_mesh(mesh: Optional[ProcessMesh]) -> Optional[ProcessMesh]:
    """Make ``mesh`` the one the tensor-parallel decoder reads; returns the
    previous one."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, mesh
    return previous


def active_mesh() -> Optional[ProcessMesh]:
    return _ACTIVE


# --- tensor parallelism of the decoder ----------------------------------
_OUT_SHARDED = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_IN_SHARDED = ("o_proj", "down_proj")


def llama_param_spec(mod: str, leaf: str = "kernel") -> Tuple[Optional[str], ...]:
    """Tensor-parallel layout of a stacked decoder layer leaf, as the
    entries of the JAX ``PartitionSpec``: ``"model"`` on the split dim.

    Megatron layout: q/k/v/gate/up split their output dim, o/down their
    input dim, so each block sums over the model group twice (after o_proj
    and after down_proj). Kernel leaves are ``[L, in, out]``; an int8
    module's ``scale [L, out]`` splits with the out dim and stays whole for
    the in-split modules."""
    out_sharded = mod in _OUT_SHARDED
    in_sharded = mod in _IN_SHARDED
    if leaf in ("kernel", "kernel_q"):
        if out_sharded:
            return (None, None, "model")
        if in_sharded:
            return (None, "model", None)
        return ()
    if leaf == "scale":
        return (None, "model") if out_sharded else ()
    return ()


#: the specs of the decoder's top-level leaves (the vocabulary splits)
_TOP_SPECS = {
    "lm_head": {"kernel": (None, "model"), "kernel_q": (None, "model"), "scale": ("model",)},
    "embed_tokens": {"embedding": ("model", None)},
}


def check_llama_divisible(cfg, n_model: int) -> None:
    """The decoder's heads, kv heads, MLP width and vocabulary must split
    evenly over ``n_model`` ranks."""
    for name in ("num_heads", "num_kv_heads", "intermediate_size", "vocab_size"):
        value = int(getattr(cfg, name))
        if value % n_model:
            raise ValueError(
                f"model.{name}={value} does not divide into model_parallel={n_model}")


def _shard(x: torch.Tensor, spec: Tuple[Optional[str], ...], mesh: ProcessMesh) -> torch.Tensor:
    if "model" not in spec:
        return x
    dim = spec.index("model")
    if x.shape[dim] % mesh.n_model:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not divide into "
                         f"model_parallel={mesh.n_model}")
    return own_storage(x.chunk(mesh.n_model, dim=dim)[mesh.model_index], x)


def own_storage(part: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``part`` of the leaf ``whole`` in storage of its own (the whole leaf
    can go), in the leaf's layout: an int8 kernel stored column-major for
    the int8 kernels stays so."""
    if whole.dim() >= 2 and whole.stride(-2) == 1 and whole.stride(-1) != 1:
        part = int8_kernel_layout(part)
    else:
        part = part.contiguous()
    # a block of leading rows is already contiguous: a view of the whole
    same = part.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
    return part.clone(memory_format=torch.preserve_format) if same else part


def partition_llama(llama_params: Dict[str, Any], mesh: ProcessMesh, cfg=None) -> Dict[str, Any]:
    """This rank's shard of the decoder (``llama_param_spec`` for the
    layer leaves, the vocabulary split of ``lm_head`` and
    ``embed_tokens``; every other leaf whole). ``cfg`` (a ``LlamaConfig``)
    is checked for even splits first."""
    if cfg is not None:
        check_llama_divisible(cfg, mesh.n_model)
    out: Dict[str, Any] = {}
    for top, sub in llama_params.items():
        if top == "layers":
            out[top] = {mod: {leaf: _shard(val, llama_param_spec(mod, leaf), mesh)
                              for leaf, val in leaves.items()}
                        for mod, leaves in sub.items()}
        elif top in _TOP_SPECS:
            specs = _TOP_SPECS[top]
            out[top] = {leaf: _shard(val, specs.get(leaf, ()), mesh) for leaf, val in sub.items()}
        else:
            out[top] = sub
    return out


def shard_decoder(model, mesh: ProcessMesh) -> None:
    """Keep this rank's shard of a ``MiniGPT4Model``'s decoder in place of
    the whole tower (the other towers stay whole)."""
    params = model.params
    if "llama" not in params:
        raise ValueError(
            "run.model_parallel applies to the LLaMA decoder tower; this model has no "
            "'llama' params to shard; remove the knob or add a partitioning rule"
        )
    model.module.llama.params = ParamTree(partition_llama(params["llama"], mesh,
                                                          model.cfg.llama))


# --- the whole decoder in checkpoints ------------------------------------
def _split_of(path: str, mesh: ProcessMesh):
    """``(dim, group, parts, index)`` of the decoder leaf at ``path`` (its
    ``/``-joined keys with a trailing ``/``; an optimizer-state key too) on
    this rank: its stage's block over the pipe group or its tensor-parallel
    shard over the model group; None where the rank holds it whole."""
    at = path.find("llama/")
    if at < 0:
        return None
    keys = path[at + len("llama/"):].split("/")[:-1]
    if mesh.pipe_group is not None and keys[0] == "layers":
        return 0, mesh.pipe_group, mesh.n_pipe, mesh.pipe_index
    if mesh.model_group is not None and mesh.n_model > 1:
        spec = (llama_param_spec(keys[1], keys[2]) if keys[0] == "layers"
                else _TOP_SPECS.get(keys[0], {}).get(keys[-1], ()))
        if "model" in spec:
            return spec.index("model"), mesh.model_group, mesh.n_model, mesh.model_index
    return None


def gather_split_leaves(tree, mesh: Optional[ProcessMesh], device, path: str = ""):
    """``tree`` (nested dicts of tensors or numpy arrays, or a flat dict
    keyed by ``/``-joined paths, as ``AdamW.state_arrays``) with every
    decoder leaf this rank holds a part of (``_split_of``) gathered whole
    over its group, as a JAX checkpoint of sharded arrays holds it. Every
    rank of the groups calls it (``device``: where the collectives run)."""
    if mesh is None:
        return tree
    if isinstance(tree, Mapping):
        return {k: gather_split_leaves(v, mesh, device, f"{path}{k}/") for k, v in tree.items()}
    split = _split_of(path, mesh)
    if split is None:
        return tree
    dim, group, parts, _ = split
    host = isinstance(tree, np.ndarray)
    part = torch.from_numpy(np.ascontiguousarray(tree)).to(device) if host else tree.detach()
    gathered = [torch.empty_like(part) for _ in range(parts)]
    dist.all_gather(gathered, part.contiguous(), group=group)
    whole = torch.cat(gathered, dim=dim)
    return whole.cpu().numpy() if host else whole


def split_leaves(tree, mesh: Optional[ProcessMesh], path: str = ""):
    """``gather_split_leaves``' inverse: this rank's part of every decoder
    leaf it holds a part of."""
    if mesh is None:
        return tree
    if isinstance(tree, Mapping):
        return {k: split_leaves(v, mesh, f"{path}{k}/") for k, v in tree.items()}
    split = _split_of(path, mesh)
    if split is None:
        return tree
    dim, _, parts, index = split
    if isinstance(tree, np.ndarray):
        return np.array_split(tree, parts, axis=dim)[index]
    return own_storage(tree.chunk(parts, dim=dim)[index], tree)


def split_grad_norm_sq(mesh: ProcessMesh):
    """The squared global norm of gradients ordered as ``paths`` (AdamW's
    ``max_grad_norm`` over the whole tree): the squares of the parts of
    split decoder leaves summed over their groups, the others counted
    once."""

    def norm_sq(paths: List[Tuple[str, ...]], grads: List[torch.Tensor]) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        split_sums: Dict[Any, torch.Tensor] = {}
        for path, g in zip(paths, grads):
            sq = torch.sum(g.float() * g.float())
            split = _split_of("/".join(path) + "/", mesh)
            if split is None:
                total = total + sq
            else:
                split_sums[split[1]] = split_sums.get(split[1], 0) + sq
        for group, sq in split_sums.items():  # one order on every rank
            dist.all_reduce(sq, group=group)
            total = total + sq
        return total

    return norm_sq
