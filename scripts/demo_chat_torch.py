#!/usr/bin/env python
"""Interactive chat demo of the PyTorch port, the twin of
``scripts/demo_chat.py``.

Drives the port's ``Chat`` helper (``models/conversation.py``) from the
terminal: upload an image, ask questions, stream answers.

    python scripts/demo_chat_torch.py --image photo.jpg [--config cfg.yaml] [--device cpu]

Without a config (or checkpoints), a tiny random-weight model answers —
useful for exercising the full pipeline interactively. A config's model
block whose checkpoint paths do not exist gives seeded synthetic weights at
its width. The model runs on ``--device``: the card by default, which must
be there (``--device cpu`` runs on the CPU).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from PIL import Image  # noqa: E402

from certifiedgpt_tpu_torch import registration  # noqa: E402,F401
from certifiedgpt_tpu_torch.common.config import Config, ConfigNode  # noqa: E402
from certifiedgpt_tpu_torch.common.registry import registry  # noqa: E402
from certifiedgpt_tpu_torch.data.processors import Blip2ImageEvalProcessor  # noqa: E402
from certifiedgpt_tpu_torch.models.conversation import Chat  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", required=True)
    parser.add_argument("--config", default=None, help="YAML with a model block")
    parser.add_argument("--template", default="minigptv2")
    parser.add_argument("--max-new-tokens", type=int, default=20)
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device the model runs on (default: cuda)")
    return parser.parse_args(argv)


def build_chat(config, template: str, device: str) -> Chat:
    """A ``Chat`` over the model of ``config``'s model block (the tiny
    random-weight model without one), built on ``device``."""
    model_cfg = Config(config).model if config else ConfigNode({"model_size": "tiny"})
    model = registry.get_model_class("minigpt4").from_config(model_cfg, device)
    return Chat(model, Blip2ImageEvalProcessor(image_size=model.cfg.vit.img_size),
                template=template)


def read_questions(prompt: str = "you> "):
    """Lines typed after ``prompt`` until end of input."""
    while True:
        try:
            yield input(prompt)
        except EOFError:
            return


def chat_loop(chat: Chat, lines, stream: bool, max_new_tokens: int, out=None):
    """Ask each non-blank line and print the answer after ``bot>``, whole
    or piece by piece as it streams; returns the answers as printed."""
    out = sys.stdout if out is None else out
    answers = []
    for line in lines:
        question = line.strip()
        if not question:
            continue
        chat.ask(question)
        if stream:
            print("bot> ", end="", flush=True, file=out)
            pieces = []
            for piece in chat.stream_answer(max_new_tokens=max_new_tokens):
                print(piece, end="", flush=True, file=out)
                pieces.append(piece)
            print(file=out)
            answers.append("".join(pieces))
        else:
            answer = chat.answer(max_new_tokens=max_new_tokens)
            print("bot>", answer, file=out)
            answers.append(answer)
    return answers


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "demo_chat_torch: --device cuda, but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to run on the CPU"
        )
    chat = build_chat(args.config, args.template, args.device)
    chat.upload_img(Image.open(args.image))
    print(f"Image loaded: {args.image}. Ask questions (ctrl-d to quit).")
    return chat_loop(chat, read_questions(), args.stream, args.max_new_tokens)


if __name__ == "__main__":
    main()
