"""Conversation prompt templates and ``wrap_instruction``.

Copy of the template half of ``certifiedgpt_tpu/models/conversation.py``
(pure Python), so that the port imports nothing of the JAX package. The
interactive ``Chat`` helper waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


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
