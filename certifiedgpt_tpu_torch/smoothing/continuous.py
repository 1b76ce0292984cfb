"""Continuous-batching dataset certification.

Port of ``certifiedgpt_tpu/smoothing/continuous.py``. The serial certify
loop (``agents/certify.py``) runs one image at a time: every chunk holds
``mc_batch`` noisy copies of one image, so the last chunk of each phase
wastes ``(-n) % mc_batch`` rows, and the card idles between an image's
phases while the host finishes decoding. This module packs draws from
several questions into every chunk. Two observations make that a pure
scheduling change:

- A certification draw is "a noisy copy of image i through the model";
  Cohen's estimation draws do not depend on the selection result at
  dispatch time (the top class c_A enters only the statistics), so all
  n0 + n draws of an image can be queued the moment it becomes active: the
  first n0 decoded labels are the selection counts, the rest the estimation
  counts, the two independent streams ``Smooth.certify`` consumes.
- The prompt is already a runtime argument of the pipeline; per-row prompts
  are a gather on the device from a fixed bank of ``num_slots`` active
  images and prompts.

Every row is an independent N(0, sigma^2) perturbation drawn from the
chunk's generator whichever image it lands on, so each image's draws are
i.i.d. and the guarantee is unchanged. The random stream differs from the
serial mode's per-image seeds: certificates are equally valid, not
bit-identical.

The host scheduling (refill, FIFO chunk building, tail padding, cancelling
an image whose outcome is already decided, lazy item loading) is the JAX
package's line for line. Dispatch waits for nothing: a chunk's row slots
and the prompt banks go to the card from pinned snapshots taken at dispatch
(``data.loader.upload``), so rewriting a host bank for the next image
cannot change a chunk still in flight; an image enters its slot of the
device bank by an in-place copy on the one stream, queued after the gathers
of every chunk dispatched before it.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from certifiedgpt_tpu_torch.data.loader import HostCopy, upload
from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch, decode_until_eos
from certifiedgpt_tpu_torch.models.minigpt4 import generate_greedy
from certifiedgpt_tpu_torch.smoothing.classifier import (
    check_dispatch_window_hbm,
    chunk_seed,
    data_parallel,
)
from certifiedgpt_tpu_torch.smoothing.smoothing import (
    ABSTAIN,
    certify_from_counts,
    min_count_for_lower_bound,
    predict_from_counts,
    predict_stop_certain,
)


def make_mixed_generate_fn(model, mc_batch: int, max_new_tokens: int, num_slots: int,
                           seq_len: int = 64, noise_dist: str = "gaussian",
                           early_exit: bool = False, mesh=None):
    """The mixed-chunk pipeline.

    Returns ``fn(image_bank, ids_bank, am_bank, pos_bank, row_slot,
    generator, sigma) -> tokens [mc_batch, T]``, where the
    banks hold the ``num_slots`` active images ``[num_slots, H, W, 3]`` and
    prompts ``[num_slots, seq_len]`` on the device and ``row_slot
    [mc_batch]`` assigns each row to a slot. The noise step
    (``fn.noise_fn``) draws on the gathered images as the JAX package's
    mixed path does: ``x + sigma * U[0, 1)`` under ``noise_dist="uniform"``,
    else ``x + sigma * N(0, 1)``, always drawn. With a ``mesh`` each rank
    draws the whole chunk, generates its rows of it and gathers the tokens
    (``classifier.make_noisy_generate_fn``)."""
    cfg = model.cfg
    dp = data_parallel(mesh, mc_batch)
    eos = model.tokenizer.eos_token_id
    pad = model.tokenizer.pad_token_id

    def noise_fn(image_bank, row_slot, generator, sigma):
        images = image_bank[row_slot]  # [mc, H, W, C] gather
        draw = torch.rand if noise_dist == "uniform" else torch.randn
        return images + sigma * draw(images.shape, generator=generator,
                                     device=images.device, dtype=images.dtype)

    def fn(image_bank, ids_bank, am_bank, pos_bank, row_slot, generator, sigma):
        if tuple(ids_bank.shape) != (num_slots, seq_len):
            # as the serial pipeline's seq_len guard: a bank of another
            # shape was built for another gen
            raise ValueError(
                f"ids_bank shape {tuple(ids_bank.shape)} != (num_slots, seq_len) "
                f"({num_slots}, {seq_len}): rebuild the banks to match this gen's BatchSpec"
            )
        images = noise_fn(image_bank, row_slot, generator, sigma)
        if dp is not None:
            images, row_slot = dp.local_rows(images), dp.local_rows(row_slot)
        batch = {"image": images, "input_ids": ids_bank[row_slot],
                 "attention_mask": am_bank[row_slot], "img_pos": pos_bank[row_slot]}
        tokens = generate_greedy(model.params, cfg, batch, max_new_tokens, eos, pad,
                                 early_exit=early_exit)
        return tokens if dp is None else dp.gather_rows(tokens)

    fn.noise_fn = noise_fn
    return fn


class LazySlice:
    """``len`` + ``__getitem__`` view of ``dataset[:limit]`` that decodes
    items on access: the agents pass this so the scheduler never holds more
    than the active images in host memory."""

    def __init__(self, dataset, limit: int):
        self._ds = dataset
        self._limit = int(limit)

    def __len__(self) -> int:
        return self._limit

    def __getitem__(self, idx: int):
        if not 0 <= idx < self._limit:
            raise IndexError(idx)
        return self._ds[idx]


class _ImageJob:
    __slots__ = (
        "index", "item", "vocab", "slot", "enqueued", "decoded",
        "sel_counts", "est_counts", "n0", "n", "result", "c_a",
    )

    def __init__(self, index, n0, n):
        # item and vocab are loaded lazily when the job reaches a slot
        # (``load``): decoding every image up front would hold the whole
        # dataset's pixels in host memory
        self.index = index
        self.item: Optional[dict] = None
        self.vocab = None
        self.slot: Optional[int] = None
        self.enqueued = 0  # draws dispatched
        self.decoded = 0  # draws whose labels landed
        self.n0 = n0
        self.n = n
        self.sel_counts: Optional[np.ndarray] = None
        self.est_counts: Optional[np.ndarray] = None
        self.result: Optional[Dict[str, Any]] = None
        self.c_a: Optional[int] = None  # selection top class, cached

    def load(self, item: dict, vocab) -> None:
        self.item = item
        self.vocab = vocab
        self.sel_counts = np.zeros(vocab.num_classes, np.int64)
        self.est_counts = np.zeros(vocab.num_classes, np.int64)

    @property
    def total(self) -> int:
        return self.n0 + self.n

    def record(self, label: int) -> None:
        # first n0 decoded labels = selection stream, the rest = estimation
        if label >= self.vocab.num_classes:
            raise ValueError(f"label {label} >= num_classes {self.vocab.num_classes}")
        if self.decoded < self.n0:
            self.sel_counts[label] += 1
        else:
            self.est_counts[label] += 1
        self.decoded += 1


class ContinuousCertifier:
    """Certify (or predict) a stream of (image, question) items with mixed
    chunks. The agent supplies ``wrap_instruction`` (an item's instruction
    to its final prompt) and ``build_vocab`` (an item to its fixed
    ``AnswerVocabulary``), so the serial and continuous modes share them."""

    def __init__(
        self,
        model,
        *,
        sigma: float,
        n0: int,
        n: int,
        alpha: float,
        mc_batch: int,
        max_new_tokens: int,
        seq_len: int,
        num_slots: int = 8,
        noise_dist: str = "gaussian",
        early_exit: bool = False,
        window: int = 4,
        gen=None,
        mode: str = "certify",
        early_abstain: bool = False,
        early_stop_radius: Optional[float] = None,
        mesh=None,
    ):
        if mode not in ("certify", "predict"):
            raise ValueError(f"mode must be certify|predict, got {mode!r}")
        if mode == "predict" and early_stop_radius is not None:
            # predict reports no radius: a radius-floor target guarantees nothing
            raise ValueError("early_stop_radius applies to certify only")
        if mode == "predict" and int(n0) != 0:
            # predict has no selection phase: every draw feeds the top-2 test
            raise ValueError("predict mode requires n0=0")
        if int(num_slots) < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if int(n) < 1:
            # zero estimation draws would consume every job without
            # dispatching a row and end as an unfinalized image in run()
            raise ValueError(f"n must be >= 1, got {n}")
        if int(window) < 1:
            # window 0 would dispatch nothing
            raise ValueError(f"window must be >= 1, got {window}")
        self.device = torch.device(model.device)
        # in-flight noisy-image buffers: a config error at construction
        # beats an out-of-memory error mid-run
        check_dispatch_window_hbm(window, mc_batch, model.cfg.vit.img_size, self.device,
                                  logger=logging.getLogger(__name__))
        self.mode = mode
        self.model = model
        self.sigma = float(sigma)
        self.n0, self.n, self.alpha = int(n0), int(n), float(alpha)
        self.mc_batch = int(mc_batch)
        self.seq_len = int(seq_len)
        self.num_slots = int(num_slots)
        self.window = int(window)
        # exact early stopping (smoothing.min_count_for_lower_bound): an
        # abstain-certain job frees its remaining draw budget, which the
        # next image's draws fill in the same chunks
        self._m_abstain = (
            min_count_for_lower_bound(0.5, self.n, self.alpha)
            if early_abstain and mode == "certify" else None
        )
        # predict's completion-certain rule (smoothing.predict_stop_certain)
        self._predict_early = bool(early_abstain) and mode == "predict"
        self._m_success = None
        if early_stop_radius is not None and self.sigma > 0:
            from scipy.stats import norm as _norm

            m = min_count_for_lower_bound(
                float(_norm.cdf(float(early_stop_radius) / self.sigma)), self.n, self.alpha,
            )
            if m <= self.n:
                self._m_success = m
        self.gen = gen or make_mixed_generate_fn(
            model, mc_batch, max_new_tokens, num_slots, seq_len=seq_len,
            noise_dist=noise_dist, early_exit=early_exit, mesh=mesh,
        )
        cfg = model.cfg
        self._spec = BatchSpec(seq_len=seq_len, num_img_tokens=cfg.num_img_tokens)
        img = cfg.vit.img_size
        self._image_bank = torch.zeros((self.num_slots, img, img, 3), dtype=torch.float32,
                                       device=self.device)
        self._ids_bank = np.zeros((self.num_slots, seq_len), np.int64)
        self._am_bank = np.zeros((self.num_slots, seq_len), np.int64)
        self._pos_bank = np.zeros((self.num_slots,), np.int64)

    # ------------------------------------------------------------------
    def _assign_slot(self, job: _ImageJob, slot: int, instruction: str):
        job.slot = slot
        # queued after the gathers of every chunk already dispatched (one
        # stream), so those chunks still read the slot's previous image
        self._image_bank[slot].copy_(
            upload(np.asarray(job.item["image"], np.float32), self.device))
        prompt = build_gen_batch(self.model.tokenizer, [instruction], self._spec)
        self._ids_bank[slot] = prompt["input_ids"][0]
        self._am_bank[slot] = prompt["attention_mask"][0]
        self._pos_bank[slot] = prompt["img_pos"][0]

    def _early_decided(self, job: _ImageJob) -> bool:
        """True when the job's final outcome is already certain. Certify:
        abstain-certain, or success past the radius-floor target
        (``min_count_for_lower_bound``); predict: every completion of the
        remaining draws returns the same decision
        (``predict_stop_certain``). No alpha is spent either way. Only
        meaningful once the selection stream is complete (c_A fixed;
        predict has n0=0, so every decoded draw counts)."""
        if self.mode == "predict":
            return self._predict_early and predict_stop_certain(
                job.est_counts, self.n - job.decoded, self.alpha
            )
        if (self._m_abstain is None and self._m_success is None) or (job.decoded < job.n0):
            return False
        if job.c_a is None:
            job.c_a = int(np.argmax(job.sel_counts))
        c = int(job.est_counts[job.c_a])
        k = job.decoded - job.n0
        if self._m_abstain is not None and c + (self.n - k) < self._m_abstain:
            return True
        return self._m_success is not None and c >= self._m_success

    def _finalize(self, job: _ImageJob) -> Dict[str, Any]:
        # the decision rules are smoothing.py's, shared with the serial Smooth
        if self.mode == "predict":
            label = predict_from_counts(job.est_counts, self.alpha)
            return {"label": label, "radius": 0.0, "index": job.index}
        label, radius = certify_from_counts(
            job.sel_counts, job.est_counts, self.n, self.alpha, self.sigma
        )
        return {"label": label, "radius": radius, "index": job.index}

    # ------------------------------------------------------------------
    def run(
        self,
        items: Sequence[dict],
        wrap_instruction: Callable[[str], str],
        build_vocab,
        seed: int = 0,
        on_result: Optional[Callable[[dict, _ImageJob], None]] = None,
        on_chunk: Optional[Callable[[int], None]] = None,
    ) -> List[Dict[str, Any]]:
        """``items`` is only indexed lazily (any ``len`` + ``__getitem__``
        sequence): each item's decoded image is pulled when its job reaches
        a slot and dropped when its result lands, so host memory holds
        O(num_slots + window) images. ``on_chunk(chunk_idx)`` fires before
        each dispatch. Chunk ``k``'s noise comes from a generator seeded by
        ``chunk_seed(seed, k)``."""
        jobs: deque = deque(_ImageJob(idx, self.n0, self.n) for idx in range(len(items)))
        results: List[Optional[Dict[str, Any]]] = [None] * len(jobs)

        active: List[Optional[_ImageJob]] = [None] * self.num_slots
        decode_queue: deque = deque()  # (tokens on their way, [job per row])
        chunk_idx = 0
        tokenizer = self.model.tokenizer

        def refill_slots():
            for slot in range(self.num_slots):
                while active[slot] is None and jobs:
                    job = jobs.popleft()
                    item = items[job.index]
                    vocab = build_vocab(item)
                    job.load(item, vocab)
                    if vocab.num_classes < 2:
                        # degenerate label set: abstain without spending
                        # draws (as Smooth.certify); the slot stays free
                        job.result = {"label": ABSTAIN, "radius": 0.0, "index": job.index}
                        results[job.index] = job.result
                        if on_result:
                            on_result(job.result, job)
                        continue
                    self._assign_slot(job, slot, wrap_instruction(job.item["instruction_input"]))
                    active[slot] = job

        def build_chunk():
            """FIFO over the active slots: the rows of the next chunk."""
            rows, row_jobs = [], []
            for slot in range(self.num_slots):
                job = active[slot]
                if job is None:
                    continue
                take = min(job.total - job.enqueued, self.mc_batch - len(rows))
                rows.extend([slot] * take)
                row_jobs.extend([job] * take)
                job.enqueued += take
                if job.enqueued >= job.total:
                    # fully dispatched: chunks already queued gathered the
                    # slot's image, so the slot can take the next image now
                    active[slot] = None
                if len(rows) == self.mc_batch:
                    break
            return rows, row_jobs

        def dispatch():
            nonlocal chunk_idx
            refill_slots()
            rows, row_jobs = build_chunk()
            if not rows:
                return False
            if on_chunk:
                on_chunk(chunk_idx)
            fill = len(rows)
            while len(rows) < self.mc_batch:  # tail of the whole run
                rows.append(rows[-1])
                row_jobs.append(None)  # padding rows: decoded but unused
            generator = torch.Generator(device=self.device)
            generator.manual_seed(chunk_seed(seed, chunk_idx))
            tokens = self.gen(
                self._image_bank,
                upload(self._ids_bank, self.device),
                upload(self._am_bank, self.device),
                upload(self._pos_bank, self.device),
                upload(np.asarray(rows, np.int64), self.device),
                generator,
                self.sigma,
            )
            chunk_idx += 1
            decode_queue.append((HostCopy(tokens), row_jobs[:fill]))
            return True

        for _ in range(self.window):
            if not dispatch():
                break

        while decode_queue:
            pending, row_jobs = decode_queue.popleft()
            tokens = pending.numpy()  # waits for the oldest chunk only
            dispatch()  # keep the card fed while the host decodes
            for i, job in enumerate(row_jobs):
                if job is None or job.result is not None:
                    # a padding row, or a row of a job already decided:
                    # its label can no longer change the certificate
                    continue
                text = decode_until_eos(tokenizer, tokens[i])
                job.record(job.vocab.label_of(text))
                done = job.decoded >= job.total
                if not done and self._early_decided(job):
                    done = True
                    # cancel the job's remaining budget: draws not yet
                    # dispatched never are (the slot refills at the next
                    # dispatch); rows in flight are decoded and skipped
                    if job.slot is not None and active[job.slot] is job:
                        active[job.slot] = None
                if done:
                    # _finalize on partial counts is exact here: the
                    # abstain-certain case is below m_abstain by
                    # construction, the success case reports the floor radius
                    job.result = self._finalize(job)
                    results[job.index] = job.result
                    if on_result:
                        on_result(job.result, job)
                    job.item = None  # release the decoded image's pixels

        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            raise RuntimeError(
                f"continuous certify finished with unfinalized images {missing[:5]}: "
                "scheduler bug"
            )
        return results  # ordered by dataset index
