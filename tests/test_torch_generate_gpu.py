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

The decode step is replayed from a CUDA graph on the card (``generate``'s
default): the graphed tokens are held against the same step run eagerly
(``cuda_graph=False``) on a tiny random model through the kernels (int8
W8A8 decoder, int8 KV cache), greedy, under ``min_length``, the repetition
penalty and sampling with a seeded generator (whose state after the call
is the eager call's); a second chunk over the reused cache captures
nothing new, a replaced weight tensor is captured anew; the launch counts
of a replayed step, held against a ``torch.profiler`` trace of a replay;
the chat's stream, also with a decode of its shape while it is open; a
slot outside the cache traps (in a process of its own).
"""

import dataclasses
import subprocess
import sys

import pytest
import torch

from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_params
from certifiedgpt_tpu_torch.ops import attention as A
from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops import quantization as Q

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


def kernel_model(device, eos_bias: float = 1.5):
    """A tiny random MiniGPT-4 whose decoder runs the kernels (int8 W8A8
    weights, weight-only int8 decode steps, int8 KV cache, bf16), with an
    lm_head bias toward EOS so that some rows stop early."""
    cfg = TM.MiniGPT4Config.tiny()
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, act_quant=True, kv_quant=True, dtype=torch.bfloat16))
    params = build_synthetic_params(cfg, device, seed=0)
    bias = torch.zeros((cfg.llama.vocab_size,), dtype=torch.float32, device=device)
    bias[EOS] = eos_bias
    params["llama"]["lm_head"]["bias"] = bias
    return MiniGPT4Model(cfg, params, ByteTokenizer())


def random_batch(model, b: int, seed: int, seq_len: int = 40):
    """A left-padded batch of random prompts and seeded images."""
    gen = torch.Generator().manual_seed(seed)
    img = model.cfg.vit.img_size
    ids = torch.randint(3, 200, (b, seq_len), generator=gen)
    mask = torch.ones((b, seq_len), dtype=torch.long)
    mask[0, :5] = 0
    ids[0, :5] = PAD
    batch = {"image": torch.randn((b, img, img, 3), generator=gen), "input_ids": ids,
             "attention_mask": mask, "img_pos": torch.full((b,), 6, dtype=torch.long)}
    return {k: v.to(model.device) for k, v in batch.items()}


GRAPH_KNOBS = {"greedy": {}, "min_length": {"min_length": 4},
               "penalty": {"repetition_penalty": 1.3, "min_length": 2},
               "sampling": {"do_sample": True, "top_p": 0.9, "temperature": 0.8}}


def _seeded(knobs, device, seed=7):
    if not knobs.get("do_sample"):
        return dict(knobs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return dict(knobs, generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPH_KNOBS), ids=list(GRAPH_KNOBS))
def test_graphed_generate_matches_the_eager_step(cuda, name):
    """Two chunks of 5 rows x 8 tokens: the replayed step's tokens equal
    the eager step's on each; the first chunk captures once, the second
    (new images over the reused cache) captures nothing; a sampling
    generator ends where the eager call leaves it."""
    model = kernel_model(cuda)
    steps = 8
    captures = TM.generate.captures
    for chunk in range(2):
        batch = random_batch(model, 5, seed=chunk)
        eager_kw, graph_kw = _seeded(GRAPH_KNOBS[name], cuda), _seeded(GRAPH_KNOBS[name], cuda)
        want = TM.generate(model.params, model.cfg, batch, steps, EOS, PAD, cuda_graph=False,
                           **eager_kw)
        got = TM.generate(model.params, model.cfg, batch, steps, EOS, PAD, **graph_kw)
        assert got.tolist() == want.tolist(), chunk
        if "generator" in graph_kw:
            assert torch.equal(graph_kw["generator"].get_state(),
                               eager_kw["generator"].get_state())
        assert TM.generate.captures == captures + 1


@pytest.mark.gpu
def test_a_replaced_weight_is_captured_anew(cuda):
    """An in-place update of a decoder weight is read by the next replay (no
    new capture); a replaced weight tensor makes a new capture, and the
    tokens equal the eager step's under the new weights."""
    model = kernel_model(cuda)
    batch = random_batch(model, 3, seed=4)
    args = (model.cfg, batch, 8, EOS, PAD)
    TM.generate(model.params, *args)
    captures = TM.generate.captures
    norm = model.module.llama.params.norm
    norm.scale.mul_(1.5)
    assert TM.generate(model.params, *args).tolist() == \
        TM.generate(model.params, *args, cuda_graph=False).tolist()
    assert TM.generate.captures == captures
    norm.scale = norm.scale.clone() * 0.5
    assert TM.generate(model.params, *args).tolist() == \
        TM.generate(model.params, *args, cuda_graph=False).tolist()
    assert TM.generate.captures == captures + 1


@pytest.mark.gpu
def test_a_replay_counts_its_launches(cuda):
    """Each replayed step adds its captured launches to the kernels'
    counters: the decode kernel once a layer, the weight-only product seven
    times a layer, no row quantization, per step launched. What a capture
    recorded is what the card runs: a ``torch.profiler`` trace of one
    replay shows each counted kernel as many times, and over a whole call
    (the prefill and the replays) the trace's launches are the counters'."""
    model = kernel_model(cuda)
    batch = random_batch(model, 4, seed=5)
    TM.generate(model.params, model.cfg, batch, 9, EOS, PAD)  # the capture
    layers = model.cfg.llama.num_layers
    (st,) = TM._decode_graphs(model.params).states.values()
    traced, ops = cuda_kernels.traced_launches(st.graph.replay)
    assert traced == st.launches and ops > sum(traced.values())
    assert st.launches[A.decode_attention_kv8] == layers
    every = cuda_kernels.LAUNCH_COUNTERS
    before = [c.launches for c in every]
    traced, _ = cuda_kernels.traced_launches(
        lambda: TM.generate(model.params, model.cfg, batch, 9, EOS, PAD))
    assert traced == {c: c.launches - n for c, n in zip(every, before) if c.launches != n}
    counters = (A.decode_attention_kv8, Q.int8_weight_forward, Q.quantize_rows)
    TM.generate.decode_steps = 0
    before = [c.launches for c in counters]
    # only the decode: the prefill's launches are taken out by running it alone
    got = TM.generate(model.params, model.cfg, batch, 1, EOS, PAD)
    prefill = [c.launches - n for c, n in zip(counters, before)]
    before = [c.launches for c in counters]
    TM.generate(model.params, model.cfg, batch, 9, EOS, PAD, early_exit=True)
    steps = TM.generate.decode_steps
    launched = [c.launches - n - p for c, n, p in zip(counters, before, prefill)]
    assert 1 <= steps <= 8 and got.shape == (4, 1)
    assert launched == [layers * steps, 7 * layers * steps, 0]


@pytest.mark.gpu
def test_stream_greedy_replays_the_captured_step(cuda):
    """The chat's stream (batch 1) yields the eager stream's tokens, and a
    second stream of the same shape captures nothing new."""
    model = kernel_model(cuda, eos_bias=0.0)
    batch = random_batch(model, 1, seed=6)
    want = list(TM.stream_greedy(model.params, model.cfg, batch, 8, EOS, PAD, cuda_graph=False))
    got = list(TM.stream_greedy(model.params, model.cfg, batch, 8, EOS, PAD))
    captures = TM.generate.captures
    again = list(TM.stream_greedy(model.params, model.cfg, batch, 8, EOS, PAD))
    assert got == want == again and TM.generate.captures == captures


@pytest.mark.gpu
def test_a_paused_stream_keeps_its_state(cuda):
    """A decode of the stream's own shape between two of its tokens takes a
    state and a capture of its own: the stream goes on with its own tokens,
    and the decode in between gives the eager step's."""
    model = kernel_model(cuda, eos_bias=0.0)
    batch, other = random_batch(model, 1, seed=6), random_batch(model, 1, seed=8)
    want = list(TM.stream_greedy(model.params, model.cfg, batch, 8, EOS, PAD, cuda_graph=False))
    stream = TM.stream_greedy(model.params, model.cfg, batch, 8, EOS, PAD)
    got = [next(stream), next(stream)]
    captures = TM.generate.captures
    between = TM.generate(model.params, model.cfg, other, 8, EOS, PAD)
    assert TM.generate.captures == captures + 1
    got += list(stream)
    assert got == want
    assert between.tolist() == TM.generate(model.params, model.cfg, other, 8, EOS, PAD,
                                           cuda_graph=False).tolist()


@pytest.mark.gpu
def test_a_slot_outside_the_cache_traps(cuda):
    """The decode kernel given a device slot outside ``[0, T)`` traps: the
    process fails, nothing is written outside the cache (in a process of
    its own: a trap ends the CUDA context)."""
    code = (
        "import torch\n"
        "from certifiedgpt_tpu_torch.ops import attention as A\n"
        "d = torch.device('cuda')\n"
        "cache = {'k': torch.zeros(2, 8, 2, 16, dtype=torch.int8, device=d),\n"
        "         'v': torch.zeros(2, 8, 2, 16, dtype=torch.int8, device=d),\n"
        "         'k_scale': torch.ones(2, 8, 2, 1, device=d),\n"
        "         'v_scale': torch.ones(2, 8, 2, 1, device=d)}\n"
        "q = torch.randn(2, 1, 2, 16, device=d, dtype=torch.bfloat16)\n"
        "slot = torch.tensor(8, dtype=torch.int32, device=d)\n"
        "A.decode_attention_kv8(q, q, q, cache, slot)\n"
        "torch.cuda.synchronize()\n"
        "print('no trap')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode != 0 and "no trap" not in res.stdout, res.stdout + res.stderr
