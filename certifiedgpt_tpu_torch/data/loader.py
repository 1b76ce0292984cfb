"""Host data loading and the copies between the host and the device.

The host half of ``certifiedgpt_tpu/data/loader.py``: ``Loader`` iterates a
dataset in a seeded order and collates batches on a background prefetch
thread, each sample loaded by a small thread pool (JPEG decode and resize
release the GIL in PIL). ``process_index`` and ``process_count`` are plain
arguments (the agents pass their mesh's ``batch_index`` and
``batch_divisor``): with more than one process, ``batch_size`` is the global
batch and each process loads its contiguous slice of every batch, in the
same seeded order on every process (``_local_slice``, the JAX package's),
and each batch carries ``__local_real_rows__``. The JAX
package's ``shard_batch`` lays a batch out over a device mesh; its
counterpart here, ``to_device``, moves the arrays onto one device and does
nothing else.

``upload`` and ``HostCopy`` are the two copies the look-ahead loops make
without waiting for the card: onto the device from a pinned snapshot of a
host array, and back into pinned host memory with an event behind the copy.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch


class Loader:
    """Shuffling, batching, drop_last, background prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"Global batch_size {batch_size} must be divisible by the "
                f"process count ({process_count})"
            )
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = max(int(num_workers), 1)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def _local_slice(self, idx: np.ndarray):
        """This process's rows of a global batch (contiguous split) and how
        many of them are real: ``(local_idx, real_rows)``. A partial final
        batch (``drop_last=False``) pads by wrapping to the next
        ``process_count`` multiple, as ``DistributedSampler`` does, so every
        process gets the same non-empty count and no sample is dropped; the
        wrapped duplicates land at the tail of the last processes' slices,
        and ``real_rows`` leaves them out for loss weighting."""
        if self.process_count <= 1:
            return idx, len(idx)
        n_real = len(idx)
        if len(idx) % self.process_count != 0:
            target = -(-len(idx) // self.process_count) * self.process_count
            reps = -(-target // len(idx))
            idx = np.tile(idx, reps)[:target]
        per = len(idx) // self.process_count
        start = self.process_index * per
        real = max(0, min(per, n_real - start))
        return idx[start : start + per], real

    def _batches(self) -> Iterator[Dict[str, Any]]:
        order = self._index_order()

        def load(i):
            return self.dataset[int(i)]

        def indices():
            for b in range(len(self)):
                idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                if len(idx) == 0 or (len(idx) < self.batch_size and self.drop_last):
                    continue
                yield self._local_slice(idx)

        def collate(samples, real):
            batch = self.dataset.collater(samples)
            if self.process_count > 1:
                batch["__local_real_rows__"] = real
            return batch

        if self.num_workers <= 1:
            for idx, real in indices():
                yield collate([load(i) for i in idx], real)
            return

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            for idx, real in indices():
                yield collate(list(pool.map(load, idx)), real)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches():
                    # bounded put so an abandoned consumer (an epoch cut
                    # short) releases the thread and its pool
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # surfaced on the consumer side
                error.append(exc)
            finally:
                # deliver the sentinel unless the consumer already left
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # the consumer broke early or finished: unblock and reap the
            # producer and its worker pool
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30)
        if error:
            raise error[0]


def upload(array, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, from a snapshot taken before
    returning: the caller may change the array at once. On the card the
    snapshot is pinned and the copy is queued on the current stream
    (``non_blocking``), so the host does not wait for the card; the pinned
    block is not reused before the copy has run."""
    device = torch.device(device)
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.clone().to(device)


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch with its numeric numpy arrays on ``device`` (``upload``);
    other fields (strings, lists) pass through."""
    return {
        key: upload(value, device)
        if isinstance(value, np.ndarray) and value.dtype != object else value
        for key, value in batch.items()
    }


class HostCopy:
    """A device tensor's copy into host memory, queued on the current
    stream behind the work that produces it: pinned memory and
    ``non_blocking`` on the card, with an event recorded after the copy.
    ``numpy()`` waits for that event alone, then returns the host array; a
    CPU tensor is its own copy."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type == "cuda":
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = tensor, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
