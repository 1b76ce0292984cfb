"""Conversation prompt templates, ``wrap_instruction`` and ``Chat``.

Port of ``certifiedgpt_tpu/models/conversation.py``: the templates are a
copy (pure Python); ``Chat`` is the interactive ask/answer helper over the
port's ``generate`` (``answer``) and a token-by-token decode over one KV
cache (``stream_answer``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 2
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in self.messages:
                out += role + message + self.sep if message else role
            return out
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2 or ""]
            out = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                out += role + message + seps[i % 2] if message else role
            return out
        raise ValueError(f"Invalid separator style: {self.sep_style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
        )


CONV_VISION_Vicuna0 = Conversation(
    system=(
        "Give the following image: <Img>ImageContent</Img>. "
        "You will be able to see the image once I provide it to you. "
        "Please answer my questions."
    ),
    roles=("Human: ", "Assistant: "),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

CONV_VISION_LLama2 = Conversation(
    system=(
        "Give the following image: <Img>ImageContent</Img>. "
        "You will be able to see the image once I provide it to you. "
        "Please answer my questions."
    ),
    roles=("<s>[INST] ", " [/INST] "),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="",
)

CONV_VISION_minigptv2 = Conversation(
    system="",
    roles=("<s>[INST] ", " [/INST]"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="",
)

TEMPLATES = {
    "vicuna0": CONV_VISION_Vicuna0,
    "llama2": CONV_VISION_LLama2,
    "minigptv2": CONV_VISION_minigptv2,
}


def wrap_instruction(instruction: str, template: Optional[str]) -> str:
    """Wrap a bare instruction in a conversation template with a blanked
    system prompt (the serving prompt convention of the eval and certify
    agents); ``template`` falsy -> the instruction passes through."""
    if not template:
        return instruction
    conv = TEMPLATES[str(template)].copy()
    conv.system = ""
    conv.append_message(conv.roles[0], instruction)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


class Chat:
    """One conversation about one image with a ``MiniGPT4Model``: upload
    the image, ask, and answer greedily (or by sampling) or stream the
    answer token by token."""

    def __init__(self, model, vis_processor, template: str = "minigptv2"):
        self.model = model
        self.vis_processor = vis_processor
        self.conv = TEMPLATES[template].copy()
        self.image: Optional[np.ndarray] = None

    def upload_img(self, image) -> None:
        if self.image is not None:
            # the prompt is split on its first <ImageHere> only: a second
            # image turn would put the new image in the old turn's slot
            raise RuntimeError("a conversation holds one image; call reset() to start a new one")
        self.image = np.asarray(self.vis_processor(image), np.float32)
        self.conv.append_message(self.conv.roles[0], "<Img><ImageHere></Img>")

    def reset(self) -> None:
        """Start a new conversation (a new image allowed)."""
        self.conv = self.conv.copy()
        self.conv.messages = []
        self.image = None

    def ask(self, text: str) -> None:
        last = self.conv.messages[-1] if self.conv.messages else None
        if last and last[0] == self.conv.roles[0] and last[1] and "</Img>" in last[1]:
            # the question joins the image turn
            last[1] = last[1] + " " + text
        else:
            self.conv.append_message(self.conv.roles[0], text)

    def _prompt_batch(self, seq_len: int):
        from certifiedgpt_tpu_torch.data.loader import to_device
        from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch

        self.conv.append_message(self.conv.roles[1], None)
        spec = BatchSpec(seq_len=seq_len, num_img_tokens=self.model.cfg.num_img_tokens)
        text = build_gen_batch(self.model.tokenizer, [self.conv.get_prompt()], spec)
        batch = to_device({"image": self.image[None], **text}, self.model.device)
        return {k: (v if k == "image" else v.long()) for k, v in batch.items()}

    def answer(self, max_new_tokens: int = 20, seq_len: int = 160, do_sample: bool = False,
               temperature: float = 1.0, top_p: float = 0.9, seed: int = 0) -> str:
        """The assistant's answer, also stored in the conversation (case
        kept: the history is the next turn's context)."""
        if self.image is None:
            raise RuntimeError("upload_img must be called before answer")
        from certifiedgpt_tpu_torch.data.text import decode_until_eos, strip_generation_markers
        from certifiedgpt_tpu_torch.models.minigpt4 import generate

        batch = self._prompt_batch(seq_len)
        generator = torch.Generator(device=self.model.device)
        generator.manual_seed(seed)
        tok = self.model.tokenizer
        with torch.no_grad():
            tokens = generate(self.model.params, self.model.cfg, batch, max_new_tokens,
                              tok.eos_token_id, tok.pad_token_id, do_sample=do_sample,
                              temperature=temperature, top_p=top_p, generator=generator)
        text = strip_generation_markers(decode_until_eos(tok, tokens[0].cpu().tolist()))
        self.conv.messages[-1][1] = text
        return text

    def stream_answer(self, max_new_tokens: int = 20, seq_len: int = 160) -> Iterator[str]:
        """Yield the greedy answer piece by piece, one decode step over the
        KV cache for each token. The growing id list is decoded and its new
        text yielded (decoding each id alone would drop SentencePiece's
        leading spaces); the history is updated at every piece, so a
        consumer that stops early leaves a whole turn."""
        if self.image is None:
            raise RuntimeError("upload_img must be called before stream_answer")
        from certifiedgpt_tpu_torch.models.llama import embed_tokens, llama_apply, lm_head_logits
        from certifiedgpt_tpu_torch.models.minigpt4 import prefill

        params, cfg, tok = self.model.params, self.model.cfg, self.model.tokenizer
        batch = self._prompt_batch(seq_len)
        with torch.no_grad():
            last, cache, cache_mask, s, prompt_len = prefill(params, cfg, batch, max_new_tokens)
            token = int(torch.argmax(lm_head_logits(params["llama"], last[0])))
        next_pos = int(prompt_len[0])
        ids: List[int] = []
        emitted = ""
        self.conv.messages[-1][1] = ""  # an answer that is EOS at once is empty
        for t in range(max_new_tokens):
            if token == tok.eos_token_id:
                break
            ids.append(token)
            text = tok.decode(ids, skip_special_tokens=True)
            piece, emitted = text[len(emitted):], text
            self.conv.messages[-1][1] = text.strip()
            yield piece
            if t == max_new_tokens - 1:
                break  # the budget is spent
            with torch.no_grad():
                tok_embed = embed_tokens(params["llama"],
                                         torch.tensor([[token]], device=last.device))
                positions = torch.tensor([[next_pos + t]], device=last.device)
                logits, _, cache = llama_apply(params["llama"], cfg.llama, tok_embed,
                                               cache_mask, positions, cache, s + t)
                token = int(torch.argmax(logits[0, -1]))
