"""Host-side tokenization and fixed-shape batches.

A copy of ``certifiedgpt_tpu/data/text.py`` (numpy only), so that the port
imports nothing of the JAX package. ``build_gen_batch`` makes left-padded
prompts; the training builders make right-padded rows with -100 labels
outside the answer span: ``build_train_batch`` one sample a row,
``pack_train_batch`` K samples a row (``segment_ids``, per-segment
``positions``, ``img_pos`` [rows, K]), ``build_multiturn_train_batch`` a
conversation a row. Each image span (marked by ``img_pos``) holds pad ids
that the model replaces with the projected query embeddings
(``models/minigpt4.assemble_embeds``). Tokenizers: ``HFTokenizer`` wraps
the HuggingFace fast tokenizer of a Vicuna checkpoint directory (pad token
``"$$"`` where it has none); ``ByteTokenizer`` is a dependency-free
byte-level tokenizer for synthetic weights and tests.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

_LOG = logging.getLogger("certifiedgpt_tpu_torch")
_WARNED: set = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        _LOG.warning(msg + " (warning once; further occurrences silent)", *args)


IMAGE_PLACEHOLDER = "<ImageHere>"
IGNORE_INDEX = -100


class ByteTokenizer:
    """Byte-level tokenizer: id = byte + 4; specials pad=0 bos=1 eos=2 unk=3."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    vocab_size = 260

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [b + 4 for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i - 4 for i in ids if 4 <= i < 260)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A HuggingFace fast tokenizer (``AutoTokenizer.from_pretrained(path,
    use_fast=True)``) with LLaMA's conventions: pad ``"$$"`` when the
    tokenizer has no pad token. ``vocab_size`` is ``len(tokenizer)`` (added
    tokens included), not the model's vocabulary. ``transformers`` is
    imported here, on the host only; without it the tokenizer cannot be
    built and this raises."""

    def __init__(self, name_or_path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as exc:
            raise ImportError(
                f"HFTokenizer({name_or_path!r}) needs the transformers package: {exc}"
            ) from exc
        self.tok = AutoTokenizer.from_pretrained(name_or_path, use_fast=True)
        if self.tok.pad_token is None:
            self.tok.pad_token = "$$"

    @property
    def pad_token_id(self) -> int:
        return self.tok.pad_token_id

    @property
    def bos_token_id(self) -> int:
        return self.tok.bos_token_id

    @property
    def eos_token_id(self) -> int:
        return self.tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


def _split_instruction(tokenizer, instruction: str) -> Tuple[List[int], List[int]]:
    """Tokenize around the ``<ImageHere>`` placeholder."""
    if IMAGE_PLACEHOLDER in instruction:
        before, after = instruction.split(IMAGE_PLACEHOLDER, 1)
    else:
        before, after = "", instruction
    return tokenizer.encode(before), tokenizer.encode(after)


@dataclasses.dataclass
class BatchSpec:
    seq_len: int
    num_img_tokens: int
    max_answer_len: int = 160


def _assemble_train_sample(
    tokenizer, instruction: str, answer: str, spec: BatchSpec, budget: int
) -> Tuple[List[int], int, int]:
    """One sample's ``[bos, before, IMG*T, after, answer, eos]`` token
    list, fitted into ``budget`` slots.

    Returns ``(full_ids, ans_start, img_offset)`` where ``ans_start`` is
    the first supervised slot and ``img_offset`` the image span's start,
    both relative to the sample. Shared by the unpacked and the packed
    (``pack_train_batch``) builders so truncation semantics stay
    identical."""
    # the image span + bos + at least one answer token must always fit
    max_before = budget - 1 - spec.num_img_tokens - 2
    if max_before < 0:
        raise ValueError(
            f"a {budget}-token budget cannot hold bos + "
            f"{spec.num_img_tokens} image tokens + an answer "
            f"(raise run.seq_len or lower run.pack_sequences)"
        )
    before, after = _split_instruction(tokenizer, instruction)
    # keep the tail of 'before' (adjacent to the image) when
    # oversized. NOTE: slice from the front, not ``[-max_before:]`` —
    # Python's ``lst[-0:]`` is the WHOLE list, so the negative form
    # silently skips truncation when max_before == 0.
    if len(before) > max_before:
        before = before[len(before) - max_before:]
    ans_ids = tokenizer.encode(answer)[: spec.max_answer_len - 1]
    prompt = (
        [tokenizer.bos_token_id]
        + before
        + [tokenizer.pad_token_id] * spec.num_img_tokens
        + after
    )
    full = prompt + ans_ids + [tokenizer.eos_token_id]
    if len(full) > budget:
        # keep the answer; truncate the text after the image span
        _warn_once(
            "train_truncation",
            "train prompt+answer exceeds its %d-token budget by %d "
            "tokens; truncating the post-image text (raise run.seq_len)",
            budget, len(full) - budget,
        )
        overflow = len(full) - budget
        keep_after = max(len(after) - overflow, 0)
        after = after[:keep_after]
        prompt = (
            [tokenizer.bos_token_id]
            + before
            + [tokenizer.pad_token_id] * spec.num_img_tokens
            + after
        )
        full = (prompt + ans_ids + [tokenizer.eos_token_id])[:budget]
    return full, min(len(prompt), budget), 1 + len(before)


def build_train_batch(
    tokenizer,
    instructions: Sequence[str],
    answers: Sequence[str],
    spec: BatchSpec,
) -> Dict[str, np.ndarray]:
    """Right-padded training batch with -100-masked labels."""
    b = len(instructions)
    s = spec.seq_len
    input_ids = np.full((b, s), tokenizer.pad_token_id, np.int32)
    labels = np.full((b, s), IGNORE_INDEX, np.int32)
    attention_mask = np.zeros((b, s), np.int32)
    img_pos = np.zeros((b,), np.int32)

    for i, (inst, ans) in enumerate(zip(instructions, answers)):
        full, ans_start, img_off = _assemble_train_sample(
            tokenizer, inst, ans, spec, s
        )
        n = len(full)
        input_ids[i, :n] = full
        attention_mask[i, :n] = 1
        labels[i, ans_start:n] = full[ans_start:n]
        img_pos[i] = img_off

    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "img_pos": img_pos,
    }


def pack_train_batch(
    tokenizer,
    instructions: Sequence[str],
    answers: Sequence[str],
    spec: BatchSpec,
    pack: int,
) -> Dict[str, np.ndarray]:
    """Pack ``pack`` training samples into each ``seq_len`` row.

    Real VQA samples fill far less than the training budget (the bench
    prompt fills ~80 of 96 slots at eval; instruction+short answer at
    S=160 leaves ~half the row as pad), and the decoder's cost scales
    with padded tokens. Packing removes the padding: B samples ship as
    ``B/pack`` rows, so the decoder touches ~``1/pack`` of the tokens
    while supervising the identical answer spans.

    Per-sample CE semantics are preserved EXACTLY (loss-parity test in
    ``tests/test_pack_sequences.py``):

    - segments are isolated by a block-diagonal causal attention mask
      (``segment_ids``: pad=0, segments 1..pack; the model attends
      within a segment only — ``models/llama.llama_apply``),
    - rotary positions restart at 0 per segment (``positions``),
    - the HF shift (logit t → label t+1) cannot leak across a boundary:
      every segment starts with bos whose label is -100, so the
      cross-boundary pair is masked, and in-segment logits depend only
      on in-segment tokens by the mask above,
    - each segment carries its own image span: ``img_pos`` is
      ``[rows, pack]`` and ``models/minigpt4.assemble_packed_embeds``
      scatters one projected image per segment.

    Samples keep their order: row r holds samples ``r*pack ..
    r*pack+pack-1``. Every segment gets the same ``seq_len // pack``
    budget — NOT whatever its predecessors left over — so whether a
    sample fits is a pure function of the config (a long row-mate can
    never starve a later segment into a data-dependent mid-run error),
    and pack=K at seq_len=S truncates exactly like the unpacked builder
    at seq_len=S/K (same ``_assemble_train_sample``). Segments still
    pack densely: each advances by its ACTUAL length, the cap only
    bounds it. The reference has no counterpart (its trainer pads every
    sample to max_txt_len, ref ``minigpt_base.py:254-318``).
    """
    if pack < 1:
        raise ValueError(f"pack_sequences must be >= 1, got {pack}")
    b = len(instructions)
    if b % pack:
        raise ValueError(
            f"batch size {b} is not divisible by pack_sequences={pack}"
        )
    s = spec.seq_len
    rows = b // pack
    input_ids = np.full((rows, s), tokenizer.pad_token_id, np.int32)
    labels = np.full((rows, s), IGNORE_INDEX, np.int32)
    attention_mask = np.zeros((rows, s), np.int32)
    segment_ids = np.zeros((rows, s), np.int32)
    positions = np.zeros((rows, s), np.int32)
    img_pos = np.zeros((rows, pack), np.int32)

    for r in range(rows):
        cur = 0
        for j in range(pack):
            inst = instructions[r * pack + j]
            ans = answers[r * pack + j]
            full, ans_start, img_off = _assemble_train_sample(
                tokenizer, inst, ans, spec, s // pack
            )
            n = len(full)
            input_ids[r, cur : cur + n] = full
            attention_mask[r, cur : cur + n] = 1
            segment_ids[r, cur : cur + n] = j + 1
            positions[r, cur : cur + n] = np.arange(n)
            labels[r, cur + ans_start : cur + n] = full[ans_start:n]
            img_pos[r, j] = cur + img_off
            cur += n

    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "img_pos": img_pos,
        "segment_ids": segment_ids,
        "positions": positions,
    }


def build_multiturn_train_batch(
    tokenizer,
    conversations: Sequence[Sequence[Tuple[str, str]]],
    spec: BatchSpec,
    user_role: str = "[INST] ",
    assistant_role: str = " [/INST]",
    end_sym: str = "",
) -> Dict[str, np.ndarray]:
    """Multi-turn conversation batch with per-turn answer targets.

    Each conversation is [(user_text, assistant_text), ...]; the first
    user turn carries ``<ImageHere>``. Labels mask every user segment
    with -100 and supervise each assistant answer (+eos), reproducing the
    reference's ``tokenize_conversation`` target layout
    (ref ``minigpt_base.py:208-252``) at fixed shape.
    """
    b = len(conversations)
    s = spec.seq_len
    input_ids = np.full((b, s), tokenizer.pad_token_id, np.int32)
    labels = np.full((b, s), IGNORE_INDEX, np.int32)
    attention_mask = np.zeros((b, s), np.int32)
    img_pos = np.zeros((b,), np.int32)

    if s < 1 + spec.num_img_tokens + 2:
        raise ValueError(
            f"seq_len {s} cannot hold bos + {spec.num_img_tokens} image "
            f"tokens + an answer"
        )

    for i, turns in enumerate(conversations):
        ids: list = [tokenizer.bos_token_id]
        labs: list = [IGNORE_INDEX]
        for t, (user, assistant) in enumerate(turns):
            user_seg = user_role + user + assistant_role
            if t == 0:
                # the model ALWAYS scatters the image span at img_pos
                # (assemble_embeds is unconditional), so the span must
                # exist even when the text lacks <ImageHere> — mirror
                # _split_instruction: a missing placeholder puts the
                # image right after bos.
                before, _, after = user_seg.partition(IMAGE_PLACEHOLDER)
                if not _:
                    before, after = "", user_seg
                before_ids = tokenizer.encode(before)
                # the span + at least one answer token must fit the
                # fixed shape — otherwise the clamped on-device
                # dynamic_update_slice would silently overwrite answer
                # embeddings while labels still supervise those slots
                max_before = s - 1 - spec.num_img_tokens - 2
                if len(before_ids) > max_before:
                    before_ids = before_ids[len(before_ids) - max_before:]
                img_pos[i] = len(ids) + len(before_ids)
                seg_ids = (
                    before_ids
                    + [tokenizer.pad_token_id] * spec.num_img_tokens
                    + tokenizer.encode(after)
                )
            else:
                seg_ids = tokenizer.encode(user_seg)
            ids += seg_ids
            labs += [IGNORE_INDEX] * len(seg_ids)

            ans_ids = tokenizer.encode(assistant + end_sym)[
                : spec.max_answer_len - 1
            ] + [tokenizer.eos_token_id]
            ids += ans_ids
            labs += ans_ids

        ids, labs = ids[:s], labs[:s]
        input_ids[i, : len(ids)] = ids
        labels[i, : len(labs)] = labs
        attention_mask[i, : len(ids)] = 1

    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "img_pos": img_pos,
    }


def build_gen_batch(tokenizer, instructions: Sequence[str],
                    spec: BatchSpec) -> Dict[str, np.ndarray]:
    """Left-padded generation batch (no answers)."""
    b = len(instructions)
    s = spec.seq_len
    input_ids = np.full((b, s), tokenizer.pad_token_id, np.int32)
    attention_mask = np.zeros((b, s), np.int32)
    img_pos = np.zeros((b,), np.int32)

    max_before = s - 1 - spec.num_img_tokens
    if max_before < 0:
        raise ValueError(f"seq_len {s} cannot hold bos + {spec.num_img_tokens} image tokens")

    for i, inst in enumerate(instructions):
        before, after = _split_instruction(tokenizer, inst)
        # keep the tail of 'before' (adjacent to the image) when oversized
        if len(before) > max_before:
            before = before[len(before) - max_before:]
        prompt = (
            [tokenizer.bos_token_id] + before
            + [tokenizer.pad_token_id] * spec.num_img_tokens + after
        )
        if len(prompt) > s:
            # keep the TAIL of the post-image text: it ends with the
            # template's assistant cue
            keep = max(s - 1 - len(before) - spec.num_img_tokens, 0)
            _warn_once(
                "gen_truncation",
                "prompt exceeds seq_len=%d by %d tokens; truncating the "
                "front of the post-image text (raise run.seq_len to fit)",
                s, len(prompt) - s,
            )
            after = after[len(after) - keep:] if keep else []
            prompt = (
                [tokenizer.bos_token_id] + before
                + [tokenizer.pad_token_id] * spec.num_img_tokens + after
            )
        pad = s - len(prompt)
        input_ids[i, pad:] = prompt
        attention_mask[i, pad:] = 1
        img_pos[i] = pad + 1 + len(before)

    return {"input_ids": input_ids, "attention_mask": attention_mask, "img_pos": img_pos}


def decode_until_eos(tokenizer, row) -> str:
    """Decode one generated-token row, stopping at the first EOS."""
    ids = [int(t) for t in row]
    eos = tokenizer.eos_token_id
    if eos in ids:
        ids = ids[: ids.index(eos)]
    return tokenizer.decode(ids, skip_special_tokens=True)


def strip_generation_markers(text: str) -> str:
    """Strip role/special markers, preserving case."""
    for marker in ("</s>", "<s>", "[/INST]", "<unk>"):
        text = text.replace(marker, "")
    return text.strip()


def clean_answer(text: str) -> str:
    """Decode-side cleanup for scoring: markers, whitespace and case."""
    return strip_generation_markers(text).lower()
