"""Host-side tokenization and fixed-shape generation batches.

The generation half of ``certifiedgpt_tpu/data/text.py`` (numpy only),
copied so that the port imports nothing of the JAX package:
``build_gen_batch`` makes left-padded prompts whose image span (marked by
``img_pos``) holds pad ids that the model replaces with the projected
query embeddings (``models/minigpt4.assemble_embeds``). The training batch
builders and the HF tokenizer wait for later slices.
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
