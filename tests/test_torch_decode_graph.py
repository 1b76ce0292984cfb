"""Port parity of the decode and PGD steps that run on the device, on the CPU,
against the JAX package at tiny sizes from numpy seeds.

The port's decode step takes its cache slot and step index from the device
(``llama_apply`` with a 0-dim int32 ``cache_offset``, ``decode_attention_kv8``
with a tensor offset, ``minigpt4._decode_step``), so that one CUDA graph
serves every step on the card; on the CPU the same step runs eagerly. Held
here: a tensor slot gives bit for bit what an int slot gives (int8 and bf16
caches, batch 1 and 3, the first, a middle and the last slot), and the JAX
``llama_apply`` at that slot within ``REL_TOL``; the restructured
``generate`` gives the JAX ``generate``'s tokens (greedy, early exit,
``min_length``, the repetition penalty), also over a reused cache whose
unwritten slots hold junk; ``stream_greedy`` gives ``generate``'s greedy
tokens, also around a decode while the stream is open; the capture key
(``layers.tree_addresses``) follows replaced weight tensors and not in-place
updates, a model keeps at most two captures and hands out no state that an
open stream holds; the lm_head (bf16 operands, f32 output) against the JAX
``lm_head_logits``; the restructured PGD against the JAX ``make_pgd_attack`` (at least 99 % of the
pixels equal, as ``tests/test_torch_attack.py`` holds it). The graphs
themselves run on the card: ``tests/test_torch_generate_gpu.py`` and
``tests/test_torch_attack_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.attack import attack as JA
from certifiedgpt_tpu.attack import clip as JC
from certifiedgpt_tpu.data.text import BatchSpec as JBatchSpec
from certifiedgpt_tpu.data.text import ByteTokenizer as JByteTokenizer
from certifiedgpt_tpu.data.text import build_gen_batch as j_build_gen_batch
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.models import qformer as JQF
from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit, quantize_llama
from certifiedgpt_tpu_torch.attack import attack as TA
from certifiedgpt_tpu_torch.attack import clip as TC
from certifiedgpt_tpu_torch.common.graphs import Captured, GraphStore
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models import qformer as TQF
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax, surrogate_params_from_jax
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy
from certifiedgpt_tpu_torch.ops import attention as TAT

# the decoder's logits against the JAX package's (relative Frobenius): f32
# within 1e-5 (the order of the f32 sums), bf16 within 2e-2 (bf16 roundings
# of intermediate values can fall the other way)
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
NAMES = ("k", "v", "k_scale", "v_scale")
QUESTION = "<Img><ImageHere></Img> what animal?"
SEQ_LEN = 40
EOS, PAD = JByteTokenizer.eos_token_id, JByteTokenizer.pad_token_id
EOS_BIAS = 2.0  # some rows emit EOS early
STEPS = 6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ----------------------------------------------------------------------
# the decoder at a slot on the device
# ----------------------------------------------------------------------
def _decoder(kv_quant: bool):
    """A tiny decoder from the JAX initializer (two query heads a kv head):
    int8 weights, f32, over an int8 cache; or bf16 weights over a bf16
    cache. Returns (JAX config, JAX params, port config, port params)."""
    dtype_j, dtype_t = (jnp.float32, torch.float32) if kv_quant else (jnp.bfloat16,
                                                                      torch.bfloat16)
    kw = dict(kv_quant=kv_quant, num_kv_heads=2)
    cfg_j = JLM.LlamaConfig.tiny(dtype=dtype_j, **kw)
    cfg_t = TLM.LlamaConfig.tiny(dtype=dtype_t, **kw)
    params = JLM.init_llama(jax.random.PRNGKey(4), cfg_j)
    if kv_quant:
        params = quantize_llama(params)
    params = jax.tree.map(np.asarray, params)
    return cfg_j, jax.tree.map(jnp.asarray, params), cfg_t, TL.tree_map(tensor_from_numpy, params)


@pytest.fixture(scope="module", params=[True, False], ids=["int8_cache", "bf16_cache"])
def decoder(request):
    return _decoder(request.param)


def _prefilled(cfg_j, jp, cfg_t, tp, b: int, s: int, total: int, seed: int):
    """A left-padded prompt of ``s`` tokens prefilled into a cache of
    ``total`` slots on both sides; returns the caches, the cache mask and
    the embedding table."""
    rng = np.random.RandomState(seed)
    table = np.asarray(jnp.asarray(jp["embed_tokens"]["embedding"]).astype(jnp.float32))
    mask = np.ones((b, s), np.int32)
    mask[0, :2] = 0
    cache_mask = np.concatenate([mask, np.ones((b, total - s), np.int32)], 1)
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    prompt = table[rng.randint(0, cfg_j.vocab_size, (b, s))]
    jcache = JLM.init_kv_cache(cfg_j, b, total)
    _, _, jcache = JLM.llama_apply(jp, cfg_j, jnp.asarray(prompt).astype(cfg_j.dtype),
                                   jnp.asarray(cache_mask), jnp.asarray(positions),
                                   kv_cache=jcache, cache_offset=jnp.int32(0))
    tcache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    TLM.llama_apply(tp, cfg_t, torch.from_numpy(prompt).to(cfg_t.dtype),
                    torch.from_numpy(cache_mask), torch.from_numpy(positions).long(), tcache, 0)
    return jcache, tcache, cache_mask, table, mask.sum(1)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("slot", ["first", "middle", "last"])
def test_llama_apply_tensor_slot_matches_int_slot(decoder, b, slot):
    """One decode step at slot ``s``, ``s + 3`` or ``T - 1``: with the slot
    as a 0-dim int32 tensor, the logits, the hidden state and every cache
    tensor bit for bit those of the int slot; the logits within
    ``REL_TOL`` of the JAX ``llama_apply`` at the same slot."""
    cfg_j, jp, cfg_t, tp = decoder
    s, total = 5, 12
    at = {"first": s, "middle": s + 3, "last": total - 1}[slot]
    jcache, tcache, cache_mask, table, next_pos = _prefilled(cfg_j, jp, cfg_t, tp, b, s, total,
                                                             seed=10 * b + at)
    rng = np.random.RandomState(at)
    x = table[rng.randint(0, cfg_j.vocab_size, (b, 1))]
    pos = (next_pos + at - s)[:, None].astype(np.int32)
    outs = {}
    for kind, offset in (("int", at), ("tensor", torch.tensor(at, dtype=torch.int32))):
        cache = {name: tuple(buf.clone() for buf in bufs) for name, bufs in tcache.items()}
        logits, hidden, cache = TLM.llama_apply(
            tp, cfg_t, torch.from_numpy(x).to(cfg_t.dtype), torch.from_numpy(cache_mask),
            torch.from_numpy(pos).long(), cache, offset)
        outs[kind] = (logits, hidden, cache)
    (li, hi, ci), (lt, ht, ct) = outs["int"], outs["tensor"]
    assert torch.equal(li, lt) and torch.equal(hi, ht)
    for name in ci:
        for a, c in zip(ci[name], ct[name]):
            assert torch.equal(a, c), name
    jl, _, _ = JLM.llama_apply(jp, cfg_j, jnp.asarray(x).astype(cfg_j.dtype),
                               jnp.asarray(cache_mask), jnp.asarray(pos), kv_cache=jcache,
                               cache_offset=jnp.int32(at))
    assert _rel(_f32(lt), np.asarray(jl, np.float32)) < REL_TOL[cfg_t.dtype]


@pytest.mark.parametrize("b,t,offset,dtype", [
    (1, 1, 0, torch.float32), (3, 17, 0, torch.float32), (3, 17, 8, torch.bfloat16),
    (1, 40, 39, torch.bfloat16), (3, 40, 20, torch.float32)])
def test_decode_attention_kv8_plain_takes_a_tensor_offset(b, t, offset, dtype):
    """``_decode_attention_kv8_plain`` (and its entry, which takes it on the
    CPU) with the offset as a 0-dim int32 tensor: the cache and the output
    bit for bit those of the int offset."""
    rng = np.random.RandomState(100 * t + offset + b)
    h, h_kv, dh = 4, 2, 16
    cache = {"k": torch.from_numpy(rng.randint(-127, 128, (b, t, h_kv, dh)).astype(np.int8)),
             "v": torch.from_numpy(rng.randint(-127, 128, (b, t, h_kv, dh)).astype(np.int8)),
             "k_scale": torch.from_numpy(rng.rand(b, t, h_kv, 1).astype(np.float32)),
             "v_scale": torch.from_numpy(rng.rand(b, t, h_kv, 1).astype(np.float32))}
    q = torch.from_numpy(rng.randn(b, 1, h, dh).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.randn(b, 1, h_kv, dh).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.randn(b, 1, h_kv, dh).astype(np.float32)).to(dtype)
    mask = torch.from_numpy((np.arange(t) <= offset)[None, None, None, :])
    results = []
    for off in (offset, torch.tensor(offset, dtype=torch.int32)):
        for fn in (TAT._decode_attention_kv8_plain, TAT.decode_attention_kv8):
            c = {name: buf.clone() for name, buf in cache.items()}
            results.append((fn(q, k, v, c, off, mask), c))
    out0, cache0 = results[0]
    for out, c in results[1:]:
        assert torch.equal(out, out0)
        for name in NAMES:
            assert torch.equal(c[name], cache0[name]), name


def test_decode_attention_kv8_refuses_a_slot_tensor_of_another_kind():
    cache = {"k": torch.zeros(1, 4, 2, 16, dtype=torch.int8),
             "v": torch.zeros(1, 4, 2, 16, dtype=torch.int8),
             "k_scale": torch.ones(1, 4, 2, 1), "v_scale": torch.ones(1, 4, 2, 1)}
    q, kv = torch.randn(1, 1, 2, 16), torch.randn(1, 1, 2, 16)
    for slot in (torch.tensor(1), torch.tensor([1], dtype=torch.int32)):
        with pytest.raises(TypeError, match="0-dim int32"):
            TAT.decode_attention_kv8(q, kv, kv, cache, slot)


# ----------------------------------------------------------------------
# generate's step on the device
# ----------------------------------------------------------------------
def _models(kv_quant: bool):
    vit = dict(img_size=28, act_quant=True)
    llama = dict(act_quant=True, kv_quant=kv_quant)
    cj = JM.MiniGPT4Config.tiny(vit=JV.EvaViTConfig.tiny(**vit),
                                qformer=JQF.QFormerConfig.tiny(encoder_width=32),
                                llama=JLM.LlamaConfig.tiny(**llama))
    ct = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                qformer=TQF.QFormerConfig.tiny(encoder_width=32),
                                llama=TLM.LlamaConfig.tiny(**llama))
    params = JM.init_minigpt4(jax.random.PRNGKey(7), cj)
    params["vit"] = quantize_eva_vit(params["vit"])
    params["llama"] = quantize_llama(params["llama"])
    bias = np.zeros((cj.llama.vocab_size,), np.float32)
    bias[EOS] = EOS_BIAS
    params["llama"]["lm_head"]["bias"] = jnp.asarray(bias)
    tree = jax.tree.map(np.asarray, params)
    jmodel = JModel(cj, jax.tree.map(jnp.asarray, tree), JByteTokenizer())
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    tmodel = MiniGPT4Model(ct, params_from_jax(tree, ct, "cpu"), ByteTokenizer())
    return jmodel, tmodel


@pytest.fixture(scope="module", params=[True, False], ids=["int8_cache", "bf16_cache"])
def models(request):
    return _models(kv_quant=request.param)


def _batches(jmodel, n: int, seed: int):
    spec = JBatchSpec(seq_len=SEQ_LEN, num_img_tokens=jmodel.cfg.num_img_tokens)
    prompt = j_build_gen_batch(jmodel.tokenizer, [QUESTION] * n, spec)
    images = np.random.RandomState(seed).randn(n, 28, 28, 3).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in prompt.items()}
    jbatch["image"] = jnp.asarray(images)
    tbatch = {k: torch.from_numpy(v).long() for k, v in prompt.items()}
    tbatch["image"] = torch.from_numpy(images)
    return jbatch, tbatch


KNOBS = {"greedy": {}, "early_exit": {"early_exit": True}, "min_length": {"min_length": 4},
         "penalty": {"repetition_penalty": 1.3},
         "penalty_min_length": {"repetition_penalty": 1.2, "min_length": 3}}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_generate_matches_jax(models, knobs):
    """The restructured loop (one ``_decode_step`` a token, its index on
    the device) gives the JAX ``generate``'s tokens, and launches
    ``max_new_tokens - 1`` steps without the early exit."""
    jmodel, tmodel = models
    jbatch, tbatch = _batches(jmodel, n=5, seed=3)
    kw = KNOBS[knobs]
    want = np.asarray(JM.generate(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD, **kw))
    TM.generate.decode_steps = 0
    got = TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if not kw.get("early_exit"):
        assert TM.generate.decode_steps == STEPS - 1
    first_eos = [list(row).index(EOS) if EOS in row else STEPS for row in want]
    assert min(first_eos) >= kw.get("min_length", 1) - 1


def test_generate_over_a_reused_cache_matches_a_fresh_one(models, monkeypatch):
    """A cache whose slots hold an earlier chunk's rows (junk here) gives
    the tokens of a fresh one, which are the JAX package's: the prefill
    writes the prompt's slots and each step's causal mask hides the slots
    after its own, so no stale row is read."""
    jmodel, tmodel = models
    jbatch, tbatch = _batches(jmodel, n=3, seed=4)
    want = np.asarray(JM.generate(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD))
    fresh = TM.init_kv_cache

    def junk_cache(cfg, batch, max_len, device="cpu"):
        cache = fresh(cfg, batch, max_len, device)
        gen = torch.Generator().manual_seed(9)
        for bufs in cache.values():
            for buf in bufs:
                if buf.dtype == torch.int8:
                    buf.copy_(torch.randint(-127, 128, buf.shape, generator=gen))
                else:
                    buf.copy_(torch.rand(buf.shape, generator=gen) * 3 + 0.5)
        return cache

    monkeypatch.setattr(TM, "init_kv_cache", junk_cache)
    got = TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stream_greedy_gives_generate_tokens(models):
    """``stream_greedy`` (the chat's stream) yields ``generate``'s greedy
    tokens of a one-row batch, EOS repeated once the row is done."""
    _, tmodel = models
    _, tbatch = _batches(models[0], n=1, seed=5)
    want = TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD)[0].tolist()
    got = list(TM.stream_greedy(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD))
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == (EOS if EOS in want[:i] else w)


def test_capture_key_follows_replaced_weights(models):
    """The key of a captured step holds the address of every decoder tensor:
    an in-place update keeps it (a replay reads the new values), a replaced
    tensor changes it (a replay would read the old one), and a model keeps
    at most two captured states, the most recently used, on its head's
    weight tensor."""
    _, tmodel = models
    llama = tmodel.module.llama.params
    key = TL.tree_addresses(tmodel.params["llama"])
    assert TL.tree_addresses(tmodel.params["llama"]) == key
    llama.norm.scale.mul_(1.0)
    assert TL.tree_addresses(tmodel.params["llama"]) == key
    old = llama.norm.scale
    llama.norm.scale = old.clone()
    try:
        assert TL.tree_addresses(tmodel.params["llama"]) != key
    finally:
        llama.norm.scale = old
    assert TL.tree_addresses(tmodel.params["llama"]) == key

    graphs = TM._decode_graphs(tmodel.params)
    assert TM._decode_graphs(tmodel.params) is graphs
    made = {}

    def make(tag):
        def fresh():
            made[tag] = Captured()
            return made[tag]
        return fresh

    try:
        a = graphs.state("a", make("a"))
        assert graphs.state("b", make("b")) is made["b"]
        assert graphs.state("a", make("a2")) is a  # kept: no new state
        assert graphs.state("c", make("c")) is made["c"]  # "b", the least recent, goes
        assert list(graphs.states) == ["a", "c"] and list(made) == ["a", "b", "c"]
    finally:
        graphs.states.clear()


def test_a_state_in_use_is_not_handed_out():
    """While a caller holds a kept state between steps (a chat's stream),
    the store hands a decode of the same key a fresh state that it does not
    keep; once the state is released it is handed out again."""
    store = GraphStore(most=2)
    held = store.state("k", Captured)
    held.in_use = True
    other = store.state("k", Captured)
    assert other is not held and store.states["k"] is held and len(store.states) == 1
    held.in_use = False
    assert store.state("k", Captured) is held


def test_a_paused_stream_keeps_its_tokens(models):
    """A decode between two tokens of an open ``stream_greedy`` leaves the
    stream's tokens as they were (on the CPU each call has a state of its
    own; ``test_torch_generate_gpu.py`` runs it over the kept captures)."""
    _, tmodel = models
    _, tbatch = _batches(models[0], n=1, seed=5)
    _, other = _batches(models[0], n=1, seed=6)
    want = list(TM.stream_greedy(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD))
    stream = TM.stream_greedy(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD)
    got = [next(stream), next(stream)]
    TM.generate(tmodel.params, tmodel.cfg, other, STEPS, EOS, PAD)
    got += list(stream)
    assert got == want


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lm_head_matches_jax(dtype):
    """The lm_head takes bf16 operands with an f32 output (no f32 copy of
    the head), and f32 for f32 weights; the bias is added. Against the JAX
    ``lm_head_logits`` (``preferred_element_type=float32``)."""
    rng = np.random.RandomState(11)
    hidden = jnp.asarray(rng.randn(3, 2, 64).astype(np.float32)).astype(dtype)
    kernel = jnp.asarray(rng.randn(64, 256).astype(np.float32) * 0.1).astype(dtype)
    bias = jnp.asarray(rng.randn(256).astype(np.float32))
    params = {"lm_head": {"kernel": kernel, "bias": bias}}
    want = np.asarray(JLM.lm_head_logits(params, hidden))
    tparams = TL.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), params)
    got = TLM.lm_head_logits(tparams, tensor_from_numpy(np.asarray(hidden)))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the PGD step
# ----------------------------------------------------------------------
def test_pgd_step_matches_jax():
    """The restructured PGD (``_pgd_step`` on a fixed pixel leaf, run
    eagerly on the CPU) against the JAX ``make_pgd_attack`` on a tiny CLIP
    ViT and ResNet ensemble: at least 99 % of the pixels equal after the
    steps, inside the ball; the attack can be called again (a new image, the
    same state layout) with the same result as a fresh attack."""
    rng = np.random.RandomState(6)
    jencs, tencs, jp, tp = [], [], {}, {}
    for name, cfg_j, cfg_t, init, jfn, tfn, key in (
            ("vit", JC.ClipViTConfig.tiny(), TC.ClipViTConfig.tiny(), JC.init_clip_vit,
             JC.clip_vit_image, TC.clip_vit_image, 0),
            ("rn", JC.ClipResNetConfig.tiny(), TC.ClipResNetConfig.tiny(), JC.init_clip_resnet,
             JC.clip_resnet_image, TC.clip_resnet_image, 1)):
        tree = jax.tree.map(np.asarray, jax.jit(init, static_argnums=1)(
            jax.random.PRNGKey(key), cfg_j))
        size = cfg_j.image_size
        jencs.append(JA.SurrogateEncoder(name, lambda p, x, f=jfn, c=cfg_j: f(p, c, x), tree,
                                         size))
        tencs.append(TA.SurrogateEncoder(name, lambda p, x, f=tfn, c=cfg_t: f(p, c, x),
                                         surrogate_params_from_jax(tree, "cpu"), size))
        jp[name], tp[name] = tree, tencs[-1].params
    eps, step, steps = 8 / 255, 1 / 255, 4
    attack = TA.make_pgd_attack(tencs, eps, step, steps)
    for seed in (1, 2):
        x = np.random.RandomState(seed).rand(1, 56, 56, 3).astype(np.float32)
        target_px = rng.rand(1, 56, 56, 3).astype(np.float32)
        jt = JA.embed_images(jencs, jp, jnp.asarray(target_px))
        tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
        ref = np.asarray(JA.make_pgd_attack(jencs, eps, step, steps)(jp, jnp.asarray(x), jt))
        with torch.no_grad():  # the attack turns autograd on for itself
            got = attack(tp, torch.from_numpy(x), tt).numpy()
            again = TA.make_pgd_attack(tencs, eps, step, steps)(tp, torch.from_numpy(x), tt)
        np.testing.assert_array_equal(got, again.numpy())
        assert np.mean(got == ref) >= 0.99
        assert np.abs(got - x).max() <= eps + 1e-6
        assert got.min() >= 0.0 and got.max() <= 1.0
    assert attack.captures == 0  # the CPU runs the step eagerly


def test_exact_f32_asks_for_deterministic_convolutions():
    """The surrogates' block also selects cuDNN's deterministic algorithms
    (a PGD loop on the card repeats bit for bit) and restores the caller's
    choice after it."""
    before = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        with TA.exact_f32():
            assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("n_in,n_out", [(448, 224), (300, 224), (28, 32), (56, 28)])
def test_resize_weights_are_the_interpolation_filter(n_in, n_out):
    """``_resize``'s contraction weights give ``F.interpolate``'s
    anti-aliased bilinear resize (within f32 rounding: the sums' order
    differs), rows summing to one."""
    rng = np.random.RandomState(n_in + n_out)
    x = torch.from_numpy(rng.rand(2, n_in, n_in, 3).astype(np.float32))
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(n_out, n_out),
                                           mode="bilinear", align_corners=False,
                                           antialias=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(TA._resize(x, n_out).numpy(), want.numpy(), atol=1e-6, rtol=0)
    weights = TA._resize_weights(n_in, n_out, torch.device("cpu"))
    np.testing.assert_allclose(weights.sum(dim=1).numpy(), 1.0, atol=1e-6)
