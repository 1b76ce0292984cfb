"""Profiler hookup on ``torch.profiler``.

Port of ``certifiedgpt_tpu/common/profiling.py``. The same run-block keys:

- ``enable_profile``: master switch
- ``profile_logdir``: where the trace is written
- ``profile_epoch`` / ``profile_step``: the (epoch, step) at which the
  trace opens (the agents' hooks give the step its meaning: the image
  index of the serial certify loops, the chunk index of the continuous
  scheduler, the step within the epoch of training)
- ``duration_ms``: how long the trace stays open
- ``profiler_port``: live capture over a port (``jax.profiler.start_server``)
  has no ``torch.profiler`` counterpart; it is logged once and the trace
  file is written all the same

The trace is a Chrome trace (``export_chrome_trace``) at
``{profile_logdir}/trace_rank{rank}_epoch{e}_step{s}.json``, with CUDA
activity when the device is the card.

The JAX class stops its trace from a ``threading.Timer``. ``torch.profiler``
is not meant to be torn down from another thread, so here the timer only
marks the window as over: the trace stops on the calling thread at the
next hook call after that (``maybe_start``, or ``poll``, which the serial
certify loop calls at every chunk it dispatches), or at ``stop`` (the
agents' ``finalize``). A window can therefore run past ``duration_ms``
until the next hook call.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

from certifiedgpt_tpu_torch.common.logging import get_logger
from certifiedgpt_tpu_torch.parallel.mesh import process_index


class Profiler:
    def __init__(self, run_cfg, device="cuda"):
        self.enabled = bool(run_cfg.get("enable_profile", False))
        self.logdir = str(run_cfg.get("profile_logdir", "profile"))
        self.epoch = int(run_cfg.get("profile_epoch", 0))
        self.step = int(run_cfg.get("profile_step", 0))
        self.duration_ms = int(run_cfg.get("duration_ms", 5000))
        self.port = run_cfg.get("profiler_port")
        self.cuda = torch.device(device).type == "cuda"
        self.trace_path: Optional[str] = None
        self._prof = None
        self._tracing = False
        self._expired = threading.Event()
        self.logger = get_logger()
        if self.enabled and self.port:
            self.logger.warning(
                "profiler_port %s: torch.profiler has no live-capture server; the "
                "trace is written to %s instead", self.port, self.logdir,
            )

    def maybe_start(self, epoch: int, step: int) -> None:
        """The hook the agents call before each step: stops a trace whose
        window is over, and opens one at (``profile_epoch``,
        ``profile_step``)."""
        self.poll()
        if not self.enabled or self._tracing or epoch != self.epoch or step != self.step:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        except Exception as exc:
            self.logger.warning("profiler trace failed: %s", exc)
            self._prof = None
            return
        self._tracing = True
        self._expired.clear()
        self.trace_path = os.path.join(
            self.logdir, f"trace_rank{process_index()}_epoch{epoch}_step{step}.json")
        self.logger.info("profiler trace started (epoch %d step %d -> %s)",
                         epoch, step, self.trace_path)
        timer = threading.Timer(self.duration_ms / 1000.0, self._expired.set)
        timer.daemon = True
        timer.start()

    def poll(self, *_) -> None:
        """Stop the open trace if its window is over."""
        if self._tracing and self._expired.is_set():
            self.stop()

    def stop(self) -> None:
        """Close the open trace, if any, and write it; idempotent."""
        if not self._tracing:
            return
        self._tracing = False
        t0 = time.perf_counter()
        try:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(self.trace_path)
            self.logger.info("profiler trace stopped: %s (stop and export %.3f s)",
                             self.trace_path, time.perf_counter() - t0)
        except Exception as exc:
            self.logger.warning("profiler stop failed: %s", exc)
        self._prof = None
