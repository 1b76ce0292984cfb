"""The port's chat demo (``scripts/demo_chat_torch.py``) against the JAX
package's (``scripts/demo_chat.py``) on the CPU: the JAX script's tiny
random-weight model, carried across by ``models/from_jax.py``, answers the
same two questions about the same written image, and both scripts print
the same ``bot>`` lines, character for character, whole and streamed."""

import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from certifiedgpt_tpu import registration  # noqa: F401
from certifiedgpt_tpu.common.config import ConfigNode as JConfigNode
from certifiedgpt_tpu.common.registry import registry as jregistry
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, config_from_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# short questions: the byte tokenizer makes every character a token, and
# the second turn's prompt carries the first turn's answer within Chat's
# seq_len of 160
QUESTIONS = "what is this?\n\nand its colour?\n"
MAX_NEW_TOKENS = 6


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdemo = _load("demo_chat")
tdemo = _load("demo_chat_torch")


@pytest.fixture(scope="module")
def models():
    """The JAX script's model (``from_config`` of the tiny block) and the
    port's model on its parameters."""
    block = {"model_size": "tiny"}
    jmodel = jregistry.get_model_class("minigpt4").from_config(JConfigNode(block))
    cfg = config_from_block(block)
    tree = jax.tree.map(np.asarray, jmodel.params)
    return jmodel, MiniGPT4Model(cfg, params_from_jax(tree, cfg, "cpu"), ByteTokenizer())


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("demo") / "image.jpg"
    rng = np.random.RandomState(3)
    Image.fromarray(rng.randint(0, 255, (40, 56, 3), dtype=np.uint8)).save(path)
    return str(path)


def _run(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(sys, "stdin", io.StringIO(QUESTIONS))
    result = main()
    return capsys.readouterr().out, result


@pytest.mark.parametrize("stream", [False, True])
def test_bot_lines_equal_the_jax_scripts(models, image_path, monkeypatch, capsys, stream):
    jmodel, tmodel = models
    seen = {}

    def port_from_config(model_cfg, device="cuda"):
        seen["block"], seen["device"] = dict(model_cfg), device
        return tmodel

    jcls = jregistry.get_model_class("minigpt4")
    monkeypatch.setattr(jcls, "from_config", classmethod(lambda cls, model_cfg: jmodel))
    monkeypatch.setattr(tdemo.registry.get_model_class("minigpt4"), "from_config",
                        port_from_config)
    flags = ["--image", image_path, "--max-new-tokens", str(MAX_NEW_TOKENS)]
    flags += ["--stream"] if stream else []
    want, _ = _run(monkeypatch, capsys, jdemo.main, ["demo_chat.py", *flags])
    got, answers = _run(monkeypatch, capsys, tdemo.main,
                        ["demo_chat_torch.py", *flags, "--device", "cpu"])
    assert seen == {"block": {"model_size": "tiny"}, "device": "cpu"}
    assert want.count("bot>") == 2 and want.count("you> ") == 4
    assert got == want
    # each answer as printed after its "bot>"
    printed = [part.split("\nyou> ")[0] for part in got.split("bot> ")[1:]]
    assert [p[:-1] if p.endswith("\n") else p for p in printed] == answers


def test_chat_loop_reads_lines_without_a_terminal(models, image_path):
    _, tmodel = models
    chat = tdemo.Chat(tmodel, tdemo.Blip2ImageEvalProcessor(image_size=tmodel.cfg.vit.img_size))
    chat.upload_img(Image.open(image_path))
    out = io.StringIO()
    answers = tdemo.chat_loop(chat, ["what is this?", "   "], False, MAX_NEW_TOKENS, out)
    assert len(answers) == 1
    assert out.getvalue() == f"bot> {answers[0]}\n"
    assert chat.conv.messages[-1][1] == answers[0]


def test_device_cuda_without_cuda_names_device_cpu(image_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tdemo.main(["--image", image_path])
