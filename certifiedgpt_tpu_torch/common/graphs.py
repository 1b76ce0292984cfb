"""A step on fixed tensors, captured once into a CUDA graph and replayed.

The counterpart of the JAX package's compiled loops: the decode step of
``models/minigpt4.generate`` and the PGD step of
``attack/attack.make_pgd_attack`` each keep the tensors their step reads and
writes in a state (a ``Captured``), their states in a ``GraphStore``, and
replay the step from the state's graph. The kernels' launch counters
(``ops/cuda_kernels.LAUNCH_COUNTERS``) count on the host, so a capture
records what it added to each and every replay adds that again.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from certifiedgpt_tpu_torch.ops.cuda_kernels import LAUNCH_COUNTERS


class Captured:
    """A state with its captured step: ``graph`` (None until captured),
    ``launches`` (what one replay adds to each kernel's counter) and
    ``in_use`` (a caller holds the state between two steps, so
    ``GraphStore.state`` hands nobody else this state)."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[Any, int] = {}
        self.in_use = False

    def replay(self) -> None:
        """One step: the graph replayed, its launches counted."""
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.launches += n


class GraphStore:
    """At most ``most`` states, the most recently used kept, whose graphs
    share one memory pool and one capture stream (made at the first
    capture)."""

    def __init__(self, most: int = 2):
        self.most = most
        self.states: "collections.OrderedDict[Hashable, Captured]" = collections.OrderedDict()
        self.pool = self.stream = None

    def state(self, key: Hashable, make: Callable[[], Captured]) -> Captured:
        """The state kept under ``key``, else ``make()`` kept in its place
        (the least recently used state dropped beyond ``most``); while the
        kept state is in use, a fresh ``make()`` that is not kept."""
        st = self.states.get(key)
        if st is not None and st.in_use:
            return make()
        if st is None:
            while len(self.states) >= self.most:
                self.states.popitem(last=False)
            st = self.states[key] = make()
        self.states.move_to_end(key)
        return st

    def capture(self, st: Captured, step: Callable[[], None], restore: Callable[[], None],
                device: torch.device, generator: Optional[torch.Generator] = None) -> None:
        """Run ``step`` once on the capture stream (a real step, whose lazy
        allocations and device queries then happen outside the capture),
        call ``restore`` to put back what it changed, and capture ``step``
        into ``st.graph`` in the store's pool, with ``generator`` registered
        so that each replay draws on from its state. The capture launches
        nothing: the counters are put back and ``st.launches`` keeps what
        it added. A capture that fails raises."""
        if self.pool is None:
            self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            step()
        current.wait_stream(self.stream)
        restore()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        counters = list(LAUNCH_COUNTERS)
        before = [c.launches for c in counters]
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            step()
        st.launches = {c: c.launches - n for c, n in zip(counters, before) if c.launches != n}
        for c, n in zip(counters, before):
            c.launches = n
        st.graph = graph
