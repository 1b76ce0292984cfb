"""The port's profiler (``common/profiling.py`` on ``torch.profiler``) and
step-metrics writer (``common/metrics.py``), on the CPU, as
``tests/test_profiling_metrics.py`` holds the JAX package's: a trace opens
only at its (epoch, step) and is written as a Chrome trace when stopped; a
disabled profiler does nothing; a failed metrics write remounts the output
directory once and writes the row; only rank 0 writes."""

import json
import os
import shutil
import time

import torch

from certifiedgpt_tpu_torch.common import metrics as TMET
from certifiedgpt_tpu_torch.common.config import ConfigNode
from certifiedgpt_tpu_torch.common.metrics import StepMetrics
from certifiedgpt_tpu_torch.common.profiling import Profiler
from certifiedgpt_tpu_torch.utils import gcs


def test_profiler_trace_window(tmp_path):
    """Wrong step: no trace. The right one opens it; the window's timer
    only marks it over, and the next hook call stops it on the calling
    thread and writes the trace; ``stop`` is idempotent."""
    profiler = Profiler(ConfigNode({
        "enable_profile": True, "profile_logdir": str(tmp_path / "trace"),
        "profile_epoch": 0, "profile_step": 1, "duration_ms": 200,
        "profiler_port": 9012}), device="cpu")
    profiler.maybe_start(epoch=0, step=0)
    assert not profiler._tracing
    profiler.maybe_start(epoch=0, step=1)
    assert profiler._tracing
    torch.ones((64, 64)).sum()
    deadline = time.monotonic() + 30
    while not profiler._expired.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert profiler._expired.is_set() and profiler._tracing  # marked, not stopped
    profiler.maybe_start(epoch=0, step=2)  # the next hook stops it
    assert not profiler._tracing
    profiler.stop()  # idempotent
    path = tmp_path / "trace" / "trace_rank0_epoch0_step1.json"
    assert str(path) == profiler.trace_path
    assert json.loads(path.read_text())["traceEvents"]


def test_profiler_disabled_noop():
    profiler = Profiler(ConfigNode({"enable_profile": False}), device="cpu")
    profiler.maybe_start(0, 0)
    assert not profiler._tracing
    profiler.stop()


def test_metrics_remount_retry(tmp_path, monkeypatch):
    """A failed metrics write remounts the output dir once and retries
    (``utils/gcs.py::ensure_mounted``), and the row is written."""
    out = tmp_path / "bucket" / "run"
    metrics = StepMetrics(str(out), "m")
    shutil.rmtree(tmp_path / "bucket")  # an unmounted bucket
    calls = []

    def fake_mount(path, bucket_name="certifiedgpt_storage"):
        calls.append(path)
        os.makedirs(path, exist_ok=True)

    monkeypatch.setattr(gcs, "ensure_mounted", fake_mount)
    metrics.log_event("after_remount")
    assert calls == [str(out)]
    assert "after_remount" in (out / "m.txt").read_text()


def test_metrics_written_by_rank_zero_only(tmp_path, monkeypatch):
    """Another rank appends nothing (every rank writing one shared file
    would interleave duplicate rows)."""
    metrics = StepMetrics(str(tmp_path), "m")
    monkeypatch.setattr(TMET, "process_index", lambda: 1)
    metrics.log_step_metrics("train", 0, 0, 1.0)
    assert not (tmp_path / "m.txt").exists()
    monkeypatch.setattr(TMET, "process_index", lambda: 0)
    metrics.log_step_metrics("train", 0, 0, 1.0)
    assert "split=train epoch=0 step=0 loss=1.000000" in (tmp_path / "m.txt").read_text()
