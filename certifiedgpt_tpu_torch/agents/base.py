"""Base agent: config and model ownership, optimizer, checkpoint and
history plumbing.

Port of ``certifiedgpt_tpu/agents/base.py``: an agent owns the config, the
output directory, the logger, the process mesh and the model, which it
builds through the port's registry on the launcher's device. The mesh
(``parallel/mesh.py``) comes from ``run.model_parallel``,
``run.dcn_parallel`` and ``run.pipeline_parallel`` over the ranks of
``torch.distributed``; with ``model_parallel`` > 1 the agent keeps only
this rank's shard of the decoder (``partition_llama``). Under
``pipeline_parallel`` > 1 the finetune agent keeps this stage's blocks
(``parallel/pipeline.py``); the serving agents keep the whole decoder,
run it sequentially and split their batch over the data ranks, as XLA
gathers the stack for the JAX serving agents. Pipe x model is refused, as
in the JAX package. Only rank 0 writes the history and the checkpoints (a
decoder split over the ranks, into stages or tensor-parallel shards, is
gathered whole into them); the others wait at a barrier after a
checkpoint. It builds the optimizer and the lr
schedule from the run block (``optim.py``), writes and reads checkpoints in
the JAX package's ``.npz`` format (trainable leaves, optimizer state,
metadata; ``vqa_finetuned`` names finetuned weights), records the loss of
each epoch and writes ``loss_history.json`` and its plot when it finishes;
a plot that fails only warns.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import torch

from certifiedgpt_tpu_torch.common.checkpoint import (
    load_checkpoint,
    load_opt_state,
    save_checkpoint,
)
from certifiedgpt_tpu_torch.common.logging import get_logger
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.optim import AdamW, build_lr_schedule
from certifiedgpt_tpu_torch.parallel.mesh import (
    barrier,
    gather_split_leaves,
    make_mesh,
    process_index,
    set_active_mesh,
    shard_decoder,
    split_grad_norm_sq,
)


class BaseAgent:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.run_cfg = config.run
        n_model = int(self.run_cfg.get("model_parallel", 1) or 1)
        n_pipe = int(self.run_cfg.get("pipeline_parallel", 1) or 1)
        if n_pipe > 1 and n_model > 1:
            raise ValueError(
                "pipeline_parallel x model_parallel composition is not wired in the agents "
                "yet (the pipeline replicates lm_head/norm; see parallel/pipeline.py) — pick "
                "one"
            )
        self.device = device
        self.logger = get_logger()
        self.output_dir = str(self.run_cfg.get("output_dir", "output"))
        os.makedirs(self.output_dir, exist_ok=True)
        self.mesh = make_mesh(n_model=n_model,
                              n_dcn=int(self.run_cfg.get("dcn_parallel", 0) or 0), n_pipe=n_pipe)
        set_active_mesh(self.mesh)
        t0 = time.perf_counter()
        self.model = self.build_model()
        if self.mesh.n_model > 1:
            # run.model_parallel > 1: this rank keeps its shard of the decoder
            shard_decoder(self.model, self.mesh)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)  # the build's device work, in its time
        self.logger.info("built model %s on %s in %.3f s", self.config.arch, device,
                         time.perf_counter() - t0)
        self.loss_history: Dict[str, list] = {"train": [], "val": []}

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return process_index() == 0

    def out_path(self, name: str) -> str:
        """``name`` in the output directory on rank 0; the null device on
        the other ranks, which compute the same results and write nothing."""
        return os.path.join(self.output_dir, name) if self.is_writer else os.devnull

    def build_model(self):
        model_cls = registry.get_model_class(self.config.arch)
        if model_cls is None:
            raise KeyError(f"Unknown model arch '{self.config.arch}'")
        return model_cls.from_config(self.config.model, device=self.device)

    def build_optimizer(self, trainable: Mapping[str, Any], schedule=None) -> AdamW:
        """AdamW over the trainable tree with the run block's schedule and
        knobs (``weight_decay``, ``beta1``/``beta2``,
        ``accumulated_gradients``, ``max_grad_norm``); a host-stateful
        schedule (``reduce_lr_on_plateau``) sets the lr between epochs."""
        run = self.run_cfg
        schedule = schedule if schedule is not None else build_lr_schedule(run)
        self.lr_schedule = schedule
        self.stateful_lr = hasattr(schedule, "step_metric")
        return AdamW(
            trainable, schedule,
            grad_norm_sq=split_grad_norm_sq(self.mesh) if self.mesh.splits_decoder else None,
            weight_decay=float(run.get("weight_decay", 0.05)),
            beta1=float(run.get("beta1", 0.9)),
            beta2=float(run.get("beta2", 0.999)),
            accumulate_steps=int(run.get("accumulated_gradients", 1)),
            max_grad_norm=run.get("max_grad_norm"),
            stateful_lr=self.stateful_lr,
        )

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def checkpoint_path(self, name: str) -> str:
        return os.path.join(self.output_dir, f"{name}.npz")

    def save_agent_checkpoint(self, name: str, trainable: Mapping[str, Any],
                              optimizer: Optional[AdamW] = None, **metadata) -> str:
        """``{name}.npz`` (and its meta sidecar) in the output directory:
        the trainable tree, the optimizer's state when given, ``metadata``.
        Rank 0 writes; every rank then waits at a barrier, so none reads a
        half-written file (the barrier runs even when the write fails).
        Decoder leaves split over the ranks (pipe stages, tensor-parallel
        shards) and their optimizer state are first gathered whole, every
        rank taking part."""
        path = self.checkpoint_path(name)
        try:
            if self.is_writer or self.mesh.splits_decoder:
                trainable = gather_split_leaves(trainable, self.mesh, self.device)
                opt_state = None if optimizer is None else gather_split_leaves(
                    optimizer.state_arrays(), self.mesh, self.device)
            if self.is_writer:
                save_checkpoint(path, trainable, opt_state, metadata)
                self.logger.info("Saved checkpoint %s", path)
        finally:
            barrier()
        return path

    def load_agent_checkpoint(self, name_or_path: str, trainable_template):
        """(trainable, optimizer state arrays or None, metadata) from a
        path, or from ``{name}.npz`` in the output directory. Under
        ``run.use_cache`` the file (and its meta sidecar) is first staged
        into the temporary directory, keyed by its full path and refreshed
        when the source is newer."""
        path = (
            name_or_path
            if os.path.exists(name_or_path)
            else self.checkpoint_path(name_or_path)
        )
        if self.run_cfg.get("use_cache", False) and os.path.exists(path):
            # key by the full source path (basenames collide across
            # experiments) and stage atomically (a killed copy must not
            # leave a reusable truncated file)
            tag = hashlib.md5(os.path.abspath(path).encode()).hexdigest()[:8]
            staged = os.path.join(tempfile.gettempdir(), f"{tag}_{os.path.basename(path)}")
            if not os.path.exists(staged) or (
                os.path.getmtime(staged) < os.path.getmtime(path)
            ):
                tmp = staged + ".partial"
                # the meta sidecar first: freshness is keyed on the staged
                # npz, so a kill between the two renames leaves the npz
                # un-staged (retried next run), never an npz without its
                # metadata
                meta = path + ".meta.json"
                if os.path.exists(meta):
                    shutil.copy(meta, tmp)
                    os.replace(tmp, staged + ".meta.json")
                shutil.copy(path, tmp)
                os.replace(tmp, staged)
                self.logger.info("staged checkpoint to %s", staged)
            path = staged
        trainable, metadata = load_checkpoint(path, trainable_template)
        return trainable, load_opt_state(path), metadata

    def load_finetuned(self, trainable_template: Mapping[str, Any]) -> Optional[Dict[str, Any]]:
        """The finetuned trainable weights the model block names
        (``vqa_finetuned``), in the template's dtypes and devices; None when
        it names none. A named file that is missing raises."""
        path = self.config.model.get("vqa_finetuned")
        if not path:
            return None
        trainable, _, meta = self.load_agent_checkpoint(str(path), trainable_template)
        self.logger.info("Loaded finetuned weights from %s (meta=%s)", path, meta)
        return trainable

    # ------------------------------------------------------------------
    def record_loss(self, split: str, value: float) -> None:
        self.loss_history.setdefault(split, []).append(float(value))

    def save_history(self) -> None:
        """``loss_history.json``, and ``loss_history.png`` when a loss was
        recorded (matplotlib; a plot that fails only warns); rank 0 only."""
        if not self.is_writer:
            return
        with open(os.path.join(self.output_dir, "loss_history.json"), "w") as handle:
            json.dump(self.loss_history, handle)
        if not any(self.loss_history.values()):
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            for split, values in self.loss_history.items():
                if values:
                    ax.plot(values, label=split)
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax.legend()
            fig.savefig(os.path.join(self.output_dir, "loss_history.png"))
            plt.close(fig)
        except Exception as exc:  # plotting must never kill a run
            self.logger.warning("loss plot failed: %s", exc)

    def run(self):  # pragma: no cover - interface
        raise NotImplementedError

    def finalize(self) -> None:
        # a trace whose window outlives the run is stopped and written here
        profiler = getattr(self, "profiler", None)
        if profiler is not None:
            profiler.stop()
        self.save_history()
        set_active_mesh(None)


def setup_agent(config, device="cuda") -> BaseAgent:
    """The agent that ``run.agent`` names, built on ``device``."""
    name = config.run.get("agent")
    agent_cls = registry.get_agent_class(name)
    if agent_cls is None:
        raise KeyError(f"Unknown agent '{name}'")
    return agent_cls(config, device=device)
