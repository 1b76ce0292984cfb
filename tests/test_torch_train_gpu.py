"""The training path's kernels under autograd, on the card.

Tests marked ``gpu`` hold the straight-through W8A8 products (the GELU +
row-quant kernel in the forward) and a tiny MiniGPT-4's training loss and
``llama_proj`` gradient through the kernels (cls-split ViT, both row-quant
kernels) against the same computed through the kernels' plain versions on
the card, and check that a packed row of padding gives finite gradients.
They skip where there is no CUDA device. This file imports neither JAX nor
the JAX package, so on the GPU machine it runs without the conftest:

    python -m pytest --noconftest tests/test_torch_train_gpu.py -q
"""

import dataclasses
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from certifiedgpt_tpu_torch.data.text import BatchSpec, ByteTokenizer, pack_train_batch
from certifiedgpt_tpu_torch.models import eva_vit as V
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_params
from certifiedgpt_tpu_torch.ops import flash_attention as FA
from certifiedgpt_tpu_torch.ops import quantization as Q

QUESTIONS = ["<Img><ImageHere></Img> what is it?", "<Img><ImageHere></Img> colour?",
             "<Img><ImageHere></Img> how many?", "<Img><ImageHere></Img> where?"] * 2
ANSWERS = ["a cat", "red", "two", "in the kitchen"] * 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def plain_kernels():
    """The path's kernels replaced by their plain versions."""
    return [mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain),
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain),
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_as_plain)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [96, 4097])
def test_w8a8_gelu_straight_through_on_gpu(cuda, rows):
    """Forward through the GELU kernel equals the A-S plain version's bit
    for bit; one launch a call; the backward (exact-erf GELU derivative,
    the dequantized weight) is within 2e-2 of autograd through ``gelu(x) @
    w`` in bf16 with the dequantized weight (the forward's int8 rounding
    does not reach it)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    k, n = 6144, 1408
    w = torch.randn((k, n), generator=g, device=cuda) / k ** 0.5
    q = Q.quantize_kernel(w)
    kq = Q.int8_kernel_layout(q["kernel_q"])
    x = (torch.randn((rows, k), generator=g, device=cuda) * 2).bfloat16().requires_grad_(True)
    r = torch.randn((rows, n), generator=g, device=cuda)
    Q.gelu_quant_rows.launches = 0
    out = Q.w8a8_gelu_matmul(x, kq, q["scale"])
    assert Q.gelu_quant_rows.launches == 1
    (out.float() * r).sum().backward()
    with mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_as_plain):
        plain = Q.w8a8_gelu_matmul(x.detach(), kq, q["scale"])
    assert torch.equal(out, plain)
    xr = x.detach().clone().requires_grad_(True)
    wd = (q["kernel_q"].float() * q["scale"]).bfloat16()
    ref = F.gelu(xr.float()).bfloat16() @ wd
    (ref.float() * r).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert _rel(x.grad, xr.grad) < 2e-2


@pytest.mark.gpu
def test_training_loss_through_the_kernels_on_gpu(cuda):
    """A tiny MiniGPT-4 with the serving knobs (int8 ViT at 224 px under
    the cls-split form with W8A8 activations, int8 W8A8 decoder), packed
    rows with the last all padding: the loss and the ``llama_proj``
    gradient through the kernels are finite and within 2e-2 (loss) and
    5e-2 (gradient) of the same through the plain versions; the kernels
    launched once a layer and stream."""
    cfg = TM.MiniGPT4Config.tiny()
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, img_size=224, attn_impl="flash_cls",
                                     act_quant=True, dtype=torch.bfloat16),
        llama=dataclasses.replace(cfg.llama, act_quant=True, dtype=torch.bfloat16))
    params = build_synthetic_params(cfg, cuda, seed=0)
    model = MiniGPT4Model(cfg, params, ByteTokenizer())
    tr = model.make_trainable(("llama_proj",))
    spec = BatchSpec(seq_len=80, num_img_tokens=cfg.num_img_tokens, max_answer_len=16)
    text = pack_train_batch(ByteTokenizer(), QUESTIONS, ANSWERS, spec, 2)
    for key, fill in (("input_ids", 0), ("attention_mask", 0), ("labels", -100),
                      ("segment_ids", 0), ("positions", 0)):
        text[key][-1] = fill
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {k: torch.from_numpy(v).long().to(cuda) for k, v in text.items()}
    batch["image"] = torch.randn((len(QUESTIONS), 224, 224, 3), generator=g, device=cuda)

    def loss_and_grad():
        for p in tr["llama_proj"].values():
            p.grad = None
        loss = TM.minigpt4_loss(model.params, cfg, batch)
        loss.backward()
        return loss.detach(), tr["llama_proj"]["kernel"].grad.clone()

    for fn in (FA.cls_split_attention_parts, Q.ln_quant_rows, Q.gelu_quant_rows):
        fn.launches = 0
    loss, grad = loss_and_grad()
    depth = cfg.vit.depth
    assert (FA.cls_split_attention_parts.launches, Q.ln_quant_rows.launches,
            Q.gelu_quant_rows.launches) == (depth, 4 * depth, 2 * depth)
    patches = plain_kernels()
    for p in patches:
        p.start()
    try:
        plain_loss, plain_grad = loss_and_grad()
    finally:
        for p in patches:
            p.stop()
    assert torch.isfinite(loss) and bool(torch.isfinite(grad).all())
    assert abs(float(loss) - float(plain_loss)) / abs(float(plain_loss)) < 2e-2
    assert _rel(grad, plain_grad) < 5e-2
