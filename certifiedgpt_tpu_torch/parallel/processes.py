"""Gloo process groups on the CPU: ``n`` ranks of one Python program.

``run_ranks(n, code, workdir)`` starts ``n`` interpreters that join a gloo
group through a file under ``workdir`` (``file://``, no TCP port, so
concurrent runs cannot cross-join), each with one intra-op thread, and runs
``code`` in each with ``RANK`` and ``WORLD_SIZE`` bound. Every process is
waited for with a timeout, so a hang fails the call instead of holding it;
on any failure every process is killed. This is how the port's
multi-process paths run without cards (``parallel/dryrun.py``, the tests).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Optional

_PRELUDE = """
import os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD_SIZE = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3], rank=RANK,
                        world_size=WORLD_SIZE)
"""

_EPILOGUE = """
if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()
"""


def run_ranks(n: int, code: str, workdir: str, timeout: float = 300.0) -> List[str]:
    """Run ``code`` on ``n`` gloo ranks; returns each rank's standard
    output, in rank order. Raises ``RuntimeError`` with the failing rank's
    output when a rank exits non-zero or the ranks outlast ``timeout``
    seconds."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(os.path.abspath(workdir), f"gloo_store_{os.getpid()}_{time.time_ns()}")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = repo + os.pathsep + child_env.get("PYTHONPATH", "")
    child_env.setdefault("OMP_NUM_THREADS", "1")
    source = _PRELUDE + code + _EPILOGUE
    procs = [
        subprocess.Popen([sys.executable, "-c", source, str(rank), str(n), store],
                         cwd=workdir, env=child_env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for rank in range(n)
    ]
    deadline = time.monotonic() + timeout
    outs: List[Optional[str]] = [None] * n
    errs: List[str] = [""] * n
    try:
        for rank, proc in enumerate(procs):
            try:
                outs[rank], errs[rank] = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} of {n} did not finish within {timeout} s")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"rank {rank} of {n} exited with {proc.returncode}:\n"
                    f"{outs[rank][-2000:]}\n{errs[rank][-6000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs
