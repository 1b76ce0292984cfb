"""The process mesh: data and tensor parallelism over ``torch.distributed``.

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

from typing import Any, Dict, Optional, Tuple

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
    """One rank's place in the ``(dcn, data, model)`` grid, with its batch
    and model groups (None without ``torch.distributed``)."""

    def __init__(self, n_dcn: int, n_data: int, n_model: int, rank: int = 0):
        self.shape = {"dcn": int(n_dcn), "data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.model_index = rank % n_model
        self.data_index = (rank // n_model) % n_data
        self.dcn_index = rank // (n_model * n_data)
        self.batch_index = self.dcn_index * n_data + self.data_index
        self.model_group = None
        self.batch_group = None

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def batch_divisor(self) -> int:
        return self.shape["dcn"] * self.shape["data"]

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


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_dcn: Optional[int] = 1
              ) -> ProcessMesh:
    """The mesh of this process: ``n_dcn`` (0 or None: 1) x ``n_data``
    (None: what the world size leaves) x ``n_model`` ranks, which must be
    the world size. Builds the batch and model groups when
    ``torch.distributed`` is initialized (every rank builds every group, in
    one order, as ``new_group`` requires)."""
    n_dcn = int(n_dcn or 1)
    n_model = int(n_model or 1)
    world, rank = process_count(), process_index()
    if n_data is None:
        if world % (n_dcn * n_model):
            raise ValueError(
                f"{world} processes do not divide into dcn_parallel={n_dcn} x "
                f"model_parallel={n_model}; pick divisors of the world size"
            )
        n_data = world // (n_dcn * n_model)
    if n_dcn * n_data * n_model != world:
        raise ValueError(
            f"the mesh dcn={n_dcn} x data={n_data} x model={n_model} = "
            f"{n_dcn * n_data * n_model} ranks, but the world size is {world} "
            "(run.distributed with one process per rank, e.g. torch.distributed.run "
            "--nproc_per_node)"
        )
    mesh = ProcessMesh(n_dcn, n_data, n_model, rank)
    if distributed():
        n_batch = n_dcn * n_data
        for b in range(n_batch):
            group = dist.new_group([b * n_model + m for m in range(n_model)])
            if b == mesh.batch_index:
                mesh.model_group = group
        for m in range(n_model):
            group = dist.new_group([b * n_model + m for b in range(n_batch)])
            if m == mesh.model_index:
                mesh.batch_group = group
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
    part = x.chunk(mesh.n_model, dim=dim)[mesh.model_index]
    # its own storage (the whole leaf can go), in the leaf's layout: an
    # int8 kernel stored column-major for torch._int_mm stays so
    if x.dim() >= 2 and x.stride(-2) == 1 and x.stride(-1) != 1:
        return int8_kernel_layout(part)
    return part.contiguous()


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
