"""Step-metrics rows, as ``certifiedgpt_tpu/common/metrics.py`` writes them.

``StepMetrics`` appends ``split/epoch/step/loss/lr`` rows and events to
``{output_dir}/{checkpoint_name}.txt`` in the JAX package's columns,
including its ``compiles[name]=N`` counter of each tracked function. There
that counter is the jit cache size of a compiled function; the port's
functions have no jit cache, so it reads -1, as the JAX package's
``jit_cache_size`` gives for a function without one. Only the process of
rank 0 (``parallel.mesh.process_index``) writes: every rank appending to a
shared file would interleave duplicate rows. A failed write remounts the
output directory once (``utils/gcs.py::ensure_mounted``, for a gcsfuse
bucket) and writes the row again; a second failure warns and the run goes
on.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from certifiedgpt_tpu_torch.common.logging import get_logger
from certifiedgpt_tpu_torch.parallel.mesh import process_index


def jit_cache_size(fn) -> int:
    """Number of compiled variants a jitted function holds; -1 for any
    other function."""
    try:
        return int(fn._cache_size())
    except Exception:
        return -1


class StepMetrics:
    def __init__(self, output_dir: str, checkpoint_name: str = "metrics"):
        self.path = os.path.join(output_dir, f"{checkpoint_name}.txt")
        os.makedirs(output_dir, exist_ok=True)
        self.logger = get_logger()
        self.tracked: Dict[str, object] = {}

    def track(self, name: str, fn) -> None:
        self.tracked[name] = fn

    def log_step_metrics(self, split: str, epoch: int, step: int, loss: float,
                         lr: Optional[float] = None) -> None:
        row = (f"{time.strftime('%Y-%m-%d %H:%M:%S')} split={split} epoch={epoch} "
               f"step={step} loss={loss:.6f}")
        if lr is not None:
            row += f" lr={lr:.8f}"
        for name, fn in self.tracked.items():
            row += f" compiles[{name}]={jit_cache_size(fn)}"
        self._append(row)

    def log_event(self, message: str) -> None:
        self._append(f"{time.strftime('%Y-%m-%d %H:%M:%S')} event={message}")

    def _append(self, row: str) -> None:
        if process_index() != 0:
            return
        try:
            with open(self.path, "a") as handle:
                handle.write(row + "\n")
        except OSError as exc:
            self.logger.warning("metrics write failed: %s; remounting", exc)
            try:
                from certifiedgpt_tpu_torch.utils.gcs import ensure_mounted

                ensure_mounted(os.path.dirname(self.path))
                with open(self.path, "a") as handle:
                    handle.write(row + "\n")
            except OSError as exc2:
                self.logger.warning("metrics write failed after remount: %s", exc2)
