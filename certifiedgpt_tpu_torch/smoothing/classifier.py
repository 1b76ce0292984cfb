"""Decoder-to-label certification mapping.

Port of ``certifiedgpt_tpu/smoothing/classifier.py``.
``Smooth`` needs a discrete classifier; MiniGPT-4 emits free text. The
bridge, fixed before any sampling so Cohen's guarantee holds:

1. ``AnswerVocabulary``: a fixed label set per question (normalized
   candidate answers + one catch-all OTHER class), or the top answers of a
   whole annotation set (``from_annotations``), normalized with the
   official VQA pipeline.
2. ``make_noisy_generate_fn``: tile the clean image to a Monte-Carlo batch,
   add noise on the device (Gaussian, or under ``noise_dist="uniform"`` the
   reference's one-sided train noise ``x + sigma * U[0, 1)``), run encode ->
   greedy decode, return token ids.
3. ``make_sample_fn``: the ``sample_fn(x, num, seed, should_stop=None)``
   of ``Smooth``. Each chunk's noise comes from a generator seeded by
   (seed, chunk index) alone, so a run stopped early sees exactly the first
   draws of the full run. The host decodes the tokens and maps them to
   labels.

Look-ahead (``window``, the run block's ``dispatch_window``): dispatching
a chunk launches all of its kernels on the current stream and queues its
tokens' copy into pinned host memory behind them (``data.loader.HostCopy``),
with no host sync. Up to ``window`` chunks are in flight; the host waits
only for the oldest one's tokens, dispatches the next chunk, then decodes
labels while the card runs, as the JAX package's loop does.

Data parallelism (``mesh``, ``parallel/mesh.py``): the Monte-Carlo batch
splits over the mesh's batch group, as the JAX package shards it over
``("dcn", "data")``. Each rank draws the chunk's whole noise tile from the
chunk's generator and keeps its own rows, so the draws are the one-process
draws; it runs its rows, and the token ids are gathered over the batch
group, so every rank counts the same labels.
"""

from __future__ import annotations

import logging
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from certifiedgpt_tpu_torch.common.stages import StageClock, stage
from certifiedgpt_tpu_torch.data.loader import HostCopy, upload
from certifiedgpt_tpu_torch.data.text import (
    BatchSpec,
    build_gen_batch,
    clean_answer,
    decode_until_eos,
)
from certifiedgpt_tpu_torch.models.minigpt4 import generate_greedy
from certifiedgpt_tpu_torch.ops.noise import noisy_tile
from certifiedgpt_tpu_torch.vqa_tools.vqa_eval import normalize_answer

_MASK64 = 0xFFFFFFFFFFFFFFFF


class AnswerVocabulary:
    """Fixed, order-stable label set; the last class id is OTHER."""

    def __init__(self, answers: Sequence[str]):
        seen: Dict[str, int] = {}
        for ans in answers:
            norm = normalize_answer(ans)
            if norm and norm not in seen:
                seen[norm] = len(seen)
        self.index = seen
        self.labels: List[str] = list(seen.keys())

    @classmethod
    def from_annotations(cls, annotations: Sequence[dict],
                         top_k: int = 3000) -> "AnswerVocabulary":
        """Global label set (``run.vocab_mode: global``): the top-K most
        frequent normalized answers over a whole annotation set, fixed
        before any sampling as Cohen's guarantee requires."""
        counts: Counter = Counter()
        for ann in annotations:
            for a in ann.get("answers", []):
                norm = normalize_answer(a.get("answer", ""))
                if norm:
                    counts[norm] += 1
        return cls([t for t, _ in counts.most_common(top_k)])

    @property
    def other_label(self) -> int:
        return len(self.labels)

    @property
    def num_classes(self) -> int:
        return len(self.labels) + 1  # + OTHER

    def label_of(self, text: str) -> int:
        norm = normalize_answer(clean_answer(text))
        return self.index.get(norm, self.other_label)

    def text_of(self, label: int) -> str:
        if 0 <= label < len(self.labels):
            return self.labels[label]
        return "<other>"


def check_dispatch_window_hbm(window: int, mc_batch: int, img_size: int,
                              device=None, logger=None,
                              free_bytes: Optional[int] = None) -> int:
    """Bytes guard for the noisy-image buffers in flight.

    Each in-flight chunk owns a ``[mc_batch, img, img, 3]`` f32 buffer.
    Raises when ``window`` of them exceed the device's free memory
    (``torch.cuda.mem_get_info``), warns past half of it; returns the
    estimated bytes. Skips the check on a CPU device (no memory figure)."""
    est = int(window) * int(mc_batch) * int(img_size) ** 2 * 3 * 4
    if free_bytes is None:
        device = torch.device(device if device is not None else "cuda")
        if device.type != "cuda":
            return est
        free_bytes, _ = torch.cuda.mem_get_info(device)
    if est > free_bytes:
        raise ValueError(
            f"dispatch window x mc_batch needs ~{est / 1e9:.1f} GB of device "
            f"memory for in-flight noisy-image buffers but only "
            f"{free_bytes / 1e9:.1f} GB is free (window={window}, "
            f"mc_batch={mc_batch}, img={img_size}); lower run.mc_batch"
        )
    if est > free_bytes // 2 and logger is not None:
        logger.warning(
            "noisy-image buffers (~%.1f GB, window=%d x mc_batch=%d) exceed "
            "half the free device memory (%.1f GB)",
            est / 1e9, window, mc_batch, free_bytes / 1e9,
        )
    return est


def chunk_seed(seed: int, chunk: int) -> int:
    """64-bit generator seed of one chunk: splitmix64 of (seed, chunk), so
    chunk noise depends on nothing else (not on the draw budget)."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + int(chunk) + 1) & _MASK64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
    return h ^ (h >> 31)


def data_parallel(mesh, mc_batch: int):
    """``mesh`` when the Monte-Carlo batch splits over its batch group
    (None without one); ``mc_batch`` must divide by the batch divisor."""
    if mesh is None or mesh.batch_group is None:
        return None
    if mc_batch % mesh.batch_divisor:
        raise ValueError(
            f"mc_batch {mc_batch} must be divisible by the mesh batch axes "
            f"dcn*data ({mesh.batch_divisor})"
        )
    return mesh


def make_noisy_generate_fn(model, sigma: float, mc_batch: int, max_new_tokens: int,
                           seq_len: int = 64, early_exit: bool = False,
                           noise_dist: str = "gaussian", mesh=None):
    """Returns ``fn(image_hwc, input_ids, attention_mask, img_pos, generator,
    clock=None) -> token ids [mc_batch, T]`` for a one-row ``[1, S]``
    prompt, which is tiled (as a view) to the Monte-Carlo batch. The noise
    is drawn as the JAX package's noise step draws it
    (``certifiedgpt_tpu/smoothing/classifier.py`` ``noise_fn``):
    ``noise_dist="uniform"`` adds ``sigma * U[0, 1)`` to every copy (the
    reference's bug-compatible train noise; always drawn, so sigma = 0
    multiplies the draw away), any other value ``noisy_tile``'s Gaussian.
    With a ``mesh`` each rank generates its rows of the tile and the tokens
    are gathered whole."""
    cfg = model.cfg
    dp = data_parallel(mesh, mc_batch)
    eos = model.tokenizer.eos_token_id
    pad = model.tokenizer.pad_token_id

    def fn(image, input_ids, attention_mask, img_pos, generator,
           clock: Optional[StageClock] = None):
        if input_ids.shape[-1] != seq_len:
            raise ValueError(
                f"prompt length {input_ids.shape[-1]} != gen seq_len {seq_len}: "
                "rebuild the prompt with the gen's BatchSpec"
            )
        with stage(clock, "noise"):
            if noise_dist == "uniform":
                tiled = noisy_tile(image, mc_batch, 0.0, generator)  # the clean tile, no draw
                images = tiled + sigma * torch.rand(tiled.shape, generator=generator,
                                                    device=image.device, dtype=torch.float32)
            else:
                images = noisy_tile(image, mc_batch, sigma, generator)
            if dp is not None:
                images = dp.local_rows(images)
        rows = images.shape[0]
        batch = {"image": images, "input_ids": input_ids.expand(rows, -1),
                 "attention_mask": attention_mask.expand(rows, -1),
                 "img_pos": img_pos.expand(rows)}
        tokens = generate_greedy(model.params, cfg, batch, max_new_tokens, eos, pad,
                                 early_exit=early_exit, clock=clock)
        return tokens if dp is None else dp.gather_rows(tokens)

    return fn


def make_sample_fn(model, instruction: str, vocab: AnswerVocabulary, sigma: float,
                   mc_batch: int = 32, max_new_tokens: int = 10, seq_len: int = 64,
                   early_exit: bool = False, clock: Optional[StageClock] = None,
                   noise_dist: str = "gaussian", window: int = 4,
                   mesh=None, on_chunk: Optional[Callable[[int], None]] = None
                   ) -> Callable[..., np.ndarray]:
    """Bind (model, question prompt, vocab, sigma) into the
    ``sample_fn(x, num, seed, should_stop=None) -> labels`` interface of
    ``Smooth``, with up to ``window`` chunks in flight. ``should_stop(
    labels_so_far)`` is polled after each chunk's labels land; when it
    fires, the labels drawn so far are returned (a prefix of the
    full-budget stream) and the chunks still in flight are abandoned (their
    device work is sunk: the window bounds that waste). A ``clock``
    synchronizes at every stage, so it serializes the chunks whatever the
    window. ``mesh`` splits each chunk over its batch group
    (``make_noisy_generate_fn``); ``on_chunk(chunk)`` is called before each
    chunk is dispatched (the agents' profiler polls there)."""
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    device = model.device
    check_dispatch_window_hbm(window, mc_batch, model.cfg.vit.img_size, device,
                              logger=logging.getLogger(__name__))
    spec = BatchSpec(seq_len=seq_len, num_img_tokens=model.cfg.num_img_tokens)
    prompt = build_gen_batch(model.tokenizer, [instruction], spec)
    p_ids, p_am, p_pos = (
        upload(prompt[k], device).long() for k in ("input_ids", "attention_mask", "img_pos")
    )
    gen = make_noisy_generate_fn(model, sigma, mc_batch, max_new_tokens,
                                 seq_len=seq_len, early_exit=early_exit,
                                 noise_dist=noise_dist, mesh=mesh)
    tokenizer = model.tokenizer

    def sample_fn(x: np.ndarray, num: int, seed: int, should_stop=None) -> np.ndarray:
        image = upload(np.asarray(x, np.float32), device)
        labels = np.empty((num,), np.int64)
        n_chunks = (num + mc_batch - 1) // mc_batch
        pending: deque = deque()

        def dispatch(chunk: int) -> None:
            if on_chunk is not None:
                on_chunk(chunk)
            generator = torch.Generator(device=device)
            generator.manual_seed(chunk_seed(seed, chunk))
            pending.append(HostCopy(gen(image, p_ids, p_am, p_pos, generator, clock=clock)))

        for chunk in range(min(window, n_chunks)):
            dispatch(chunk)
        next_chunk = min(window, n_chunks)
        done = 0
        while pending:
            tokens = pending.popleft().numpy()  # waits for the oldest chunk only
            if next_chunk < n_chunks:
                dispatch(next_chunk)
                next_chunk += 1
            with stage(clock, "host_labels"):
                take = min(mc_batch, num - done)
                for i in range(take):
                    labels[done + i] = vocab.label_of(decode_until_eos(tokenizer, tokens[i]))
                done += take
            if done >= num:
                break
            if should_stop is not None and should_stop(labels[:done]):
                return labels[:done]
        return labels

    return sample_fn
