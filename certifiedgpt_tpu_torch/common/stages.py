"""Per-stage wall time of the certify path, for measurement runs.

A ``StageClock`` passed down the certify path (sampler -> generate ->
encode) adds each named stage's seconds and counts named events. Each
stage synchronizes the device at its start and end, so its time is the
device time of its work plus the host's launch overhead. Without a clock
(``None``, the default) nothing synchronizes and nothing is recorded.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch


class StageClock:
    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n


def stage(clock: Optional[StageClock], name: str):
    """``clock(name)``, or a no-op context without a clock."""
    return clock(name) if clock is not None else contextlib.nullcontext()
