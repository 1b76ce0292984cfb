"""Base agent: config and model ownership, checkpoint and history plumbing.

The serving half of ``certifiedgpt_tpu/agents/base.py``: an agent owns the
config, the output directory, the logger and the model, which it builds
through the port's registry on the launcher's device (one device: the
JAX package's device mesh has no counterpart yet). It reads the finetuned
weights a model block names (``vqa_finetuned``) from the JAX package's
``.npz`` format and writes ``loss_history.json`` when it finishes. The
optimizer half waits for training (ROADMAP.md, modules item 14).
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

from certifiedgpt_tpu_torch.common.checkpoint import load_checkpoint
from certifiedgpt_tpu_torch.common.logging import get_logger
from certifiedgpt_tpu_torch.common.registry import registry

#: run-block knobs that place a run on more than one device
PARALLEL_KNOBS = ("model_parallel", "pipeline_parallel", "dcn_parallel")


class BaseAgent:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.run_cfg = config.run
        for key in PARALLEL_KNOBS:
            if int(self.run_cfg.get(key, 1) or 1) > 1:
                raise NotImplementedError(
                    f"run.{key} = {self.run_cfg.get(key)}: multi-device runs are not "
                    "ported yet (ROADMAP.md, modules item 16: parallel/)"
                )
        self.device = device
        self.logger = get_logger()
        self.output_dir = str(self.run_cfg.get("output_dir", "output"))
        os.makedirs(self.output_dir, exist_ok=True)
        t0 = time.perf_counter()
        self.model = self.build_model()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)  # the build's device work, in its time
        self.logger.info("built model %s on %s in %.3f s", self.config.arch, device,
                         time.perf_counter() - t0)
        self.loss_history: Dict[str, list] = {"train": [], "val": []}

    def build_model(self):
        model_cls = registry.get_model_class(self.config.arch)
        if model_cls is None:
            raise KeyError(f"Unknown model arch '{self.config.arch}'")
        return model_cls.from_config(self.config.model, device=self.device)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def checkpoint_path(self, name: str) -> str:
        return os.path.join(self.output_dir, f"{name}.npz")

    def load_agent_checkpoint(self, name_or_path: str, trainable_template):
        """(trainable, metadata) from a path, or from ``{name}.npz`` in the
        output directory. Under ``run.use_cache`` the file (and its meta
        sidecar) is first staged into the temporary directory, keyed by its
        full path and refreshed when the source is newer."""
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
        return load_checkpoint(path, trainable_template)

    def load_finetuned(self, trainable_template: Mapping[str, Any]) -> Optional[Dict[str, Any]]:
        """The finetuned trainable weights the model block names
        (``vqa_finetuned``), in the template's dtypes and devices; None when
        it names none. A named file that is missing raises."""
        path = self.config.model.get("vqa_finetuned")
        if not path:
            return None
        trainable, meta = self.load_agent_checkpoint(str(path), trainable_template)
        self.logger.info("Loaded finetuned weights from %s (meta=%s)", path, meta)
        return trainable

    # ------------------------------------------------------------------
    def save_history(self) -> None:
        with open(os.path.join(self.output_dir, "loss_history.json"), "w") as handle:
            json.dump(self.loss_history, handle)

    def run(self):  # pragma: no cover - interface
        raise NotImplementedError

    def finalize(self) -> None:
        self.save_history()


def setup_agent(config, device="cuda") -> BaseAgent:
    """The agent that ``run.agent`` names, built on ``device``."""
    name = config.run.get("agent")
    agent_cls = registry.get_agent_class(name)
    if agent_cls is None:
        raise KeyError(f"Unknown agent '{name}'")
    return agent_cls(config, device=device)
