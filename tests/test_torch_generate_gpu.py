"""The early exit of ``generate`` with the exit firing, on the card.

On the card the host reads the "every row is done" flags only behind
completed events (``Event.query``) and never waits for them, so the exit is
seen a few steps late or not at all; on the CPU the flags are written when
``record`` returns. A tiny model whose decoder weights chain each prompt's
last token to EOS makes rows finish at chosen steps. Tests marked ``gpu``
skip where there is no CUDA device; ``test_torch_continuous.py`` holds the
same model against the full loop on the CPU. This file imports neither JAX
nor the JAX package, so on the GPU machine it runs without the conftest:

    python -m pytest --noconftest tests/test_torch_generate_gpu.py -q
"""

import pytest
import torch

from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

# (last prompt token, the tokens it leads to): each token leads to the next,
# the last to EOS (2); a token outside the chains leads to itself
CHAINS = [(20, []), (10, [11, 12]), (30, [31, 32, 33, 34]), (40, [41])]
EOS, PAD = 2, 0


def chain_model(device="cpu"):
    """The tiny model whose decoder maps each token to the next of its
    chain: attention and MLP outputs zeroed, one-hot embeddings, and an LM
    head that sends each one-hot to its successor."""
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, device)
    llama = model.params["llama"]
    for name in ("o_proj", "down_proj"):
        for leaf in llama["layers"][name].values():
            leaf.zero_()
    emb = llama["embed_tokens"]["embedding"]
    d = emb.shape[1]
    emb.copy_(torch.eye(d, dtype=emb.dtype, device=emb.device)[
        torch.arange(emb.shape[0], device=emb.device) % d])
    head = llama["lm_head"]["kernel"]
    head.zero_()
    for tok in range(d):
        head[tok, tok] = 1.0
    for first, chain in CHAINS:
        seq = [first] + chain + [EOS]
        for a, b in zip(seq, seq[1:]):
            head[a, a] = 0.0
            head[a, b] = 1.0
    if llama["lm_head"].get("bias") is not None:
        llama["lm_head"]["bias"].zero_()
    llama["norm"]["scale"].fill_(1.0)
    return model


def chain_batch(model, rows, seq_len=40):
    """A left-padded batch whose row i ends its prompt on the first token of
    ``CHAINS[rows[i]]``, with seeded images."""
    b, img = len(rows), model.cfg.vit.img_size
    ids = torch.full((b, seq_len), 5, dtype=torch.long)
    ids[:, -1] = torch.tensor([CHAINS[r][0] for r in rows])
    batch = {"image": torch.randn((b, img, img, 3), generator=torch.Generator().manual_seed(0)),
             "input_ids": ids, "attention_mask": torch.ones((b, seq_len), dtype=torch.long),
             "img_pos": torch.full((b,), 2, dtype=torch.long)}
    return {k: v.to(model.device) for k, v in batch.items()}


def chain_tokens(rows, steps):
    """The greedy output of ``chain_model`` for ``rows`` over ``steps``."""
    want = [CHAINS[r][1] + [EOS] for r in rows]
    return [t + [PAD] * (steps - len(t)) for t in want]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [1, 1, 3], [0, 2]], ids=["mixed", "short", "spread"])
def test_early_exit_fires_on_gpu_without_a_sync(cuda, rows):
    """With the exit on, the tokens are the full loop's, the host launched
    at least the steps until the last EOS and fewer than the full loop's,
    and no call of ``generate`` made the host wait for the card."""
    model = chain_model(cuda)
    steps = 24
    batch = chain_batch(model, rows)
    TM.generate(model.params, model.cfg, batch, steps, EOS, PAD)  # warm-up
    outs, launched = {}, {}
    for early in (False, True):
        TM.generate.decode_steps = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = TM.generate(model.params, model.cfg, batch, steps, EOS, PAD, early_exit=early)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs[early] = out.cpu().tolist()
        launched[early] = TM.generate.decode_steps
    assert outs[True] == outs[False] == chain_tokens(rows, steps)
    longest = max(len(CHAINS[r][1]) + 1 for r in rows)
    assert launched[False] == steps - 1
    assert longest <= launched[True] < steps - 1
