"""Port parity of the decode knobs, on the CPU, with the JAX package on the
same weights (a tiny model with the serving knobs: int8 ViT and decoder,
W8A8, an int8 KV cache, and one with a bf16 cache, an LM-head bias that
makes EOS likely): ``generate_beam``'s tokens for 1-3 beams and two length
penalties, ``rank_answers``' order, ``Chat``'s greedy answer and stream,
the nucleus filter, the repetition penalty and ``min_length`` and the
tokens they give, sampling with one token left in the nucleus; and the
sampler against the filtered softmax by a statistical test. Also the
Q-Former's text surface and its carrying across by ``params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.data.text import BatchSpec as JBatchSpec
from certifiedgpt_tpu.data.text import ByteTokenizer as JByteTokenizer
from certifiedgpt_tpu.data.text import build_gen_batch as j_build_gen_batch
from certifiedgpt_tpu.data.text import build_train_batch as j_build_train_batch
from certifiedgpt_tpu.models import conversation as JCONV
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.models import qformer as JQF
from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit, quantize_llama
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import conversation as TCONV
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models import qformer as TQF
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.ops.quantization import ieee_div

QUESTION = "<Img><ImageHere></Img> what animal?"
SEQ_LEN = 40
EOS, PAD = JByteTokenizer.eos_token_id, JByteTokenizer.pad_token_id
EOS_BIAS = 2.0  # some rows emit EOS early
STEPS = 6
# tolerance of the sampler's empirical frequencies against the filtered
# softmax: 20000 draws give a standard error of at most 0.0035
SAMPLE_DRAWS, SAMPLE_TOL = 20000, 0.015


def _cfgs(kv_quant: bool):
    vit = dict(img_size=28, act_quant=True)
    llama = dict(act_quant=True, kv_quant=kv_quant)
    cj = JM.MiniGPT4Config.tiny(vit=JV.EvaViTConfig.tiny(**vit),
                                qformer=JQF.QFormerConfig.tiny(encoder_width=32),
                                llama=JLM.LlamaConfig.tiny(**llama))
    ct = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                qformer=TQF.QFormerConfig.tiny(encoder_width=32),
                                llama=TLM.LlamaConfig.tiny(**llama))
    return cj, ct


def _models(kv_quant: bool):
    cj, ct = _cfgs(kv_quant)
    params = JM.init_minigpt4(jax.random.PRNGKey(1), cj)
    params["vit"] = quantize_eva_vit(params["vit"])
    params["llama"] = quantize_llama(params["llama"])
    bias = np.zeros((cj.llama.vocab_size,), np.float32)
    bias[EOS] = EOS_BIAS
    params["llama"]["lm_head"]["bias"] = jnp.asarray(bias)
    tree = jax.tree.map(np.asarray, params)
    jmodel = JModel(cj, jax.tree.map(jnp.asarray, tree), JByteTokenizer())
    tmodel = MiniGPT4Model(ct, params_from_jax(tree, ct, "cpu"), ByteTokenizer())
    return jmodel, tmodel


@pytest.fixture(scope="module")
def models():
    return _models(kv_quant=True)


@pytest.fixture(scope="module")
def models_bf16_cache():
    return _models(kv_quant=False)


def _batches(jmodel, n=5, seed=0):
    spec = JBatchSpec(seq_len=SEQ_LEN, num_img_tokens=jmodel.cfg.num_img_tokens)
    prompt = j_build_gen_batch(jmodel.tokenizer, [QUESTION] * n, spec)
    images = np.random.RandomState(seed).randn(n, 28, 28, 3).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in prompt.items()}
    jbatch["image"] = jnp.asarray(images)
    tbatch = {k: torch.from_numpy(v).long() for k, v in prompt.items()}
    tbatch["image"] = torch.from_numpy(images)
    return jbatch, tbatch


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------
@pytest.mark.parametrize("num_beams,length_penalty", [(1, 1.0), (2, 1.0), (3, 1.0),
                                                      (2, 0.5), (3, 0.5)])
def test_generate_beam_matches_jax(models, num_beams, length_penalty):
    """Over the int8 KV cache (codes and scales gathered on reorder)."""
    jmodel, tmodel = models
    jbatch, tbatch = _batches(jmodel)
    want = np.asarray(JM.generate_beam(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD,
                                       num_beams=num_beams, length_penalty=length_penalty))
    got = TM.generate_beam(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD,
                           num_beams=num_beams, length_penalty=length_penalty).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_beam_over_a_bf16_cache_matches_jax(models_bf16_cache):
    jmodel, tmodel = models_bf16_cache
    jbatch, tbatch = _batches(jmodel, seed=1)
    want = np.asarray(JM.generate_beam(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD,
                                       num_beams=3))
    got = TM.generate_beam(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD, num_beams=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == EOS).any()  # some beam finished, and was frozen


def test_one_beam_is_greedy(models):
    _, tmodel = models
    _, tbatch = _batches(models[0], seed=2)
    beam = TM.generate_beam(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD, num_beams=1)
    greedy = TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD)
    assert torch.equal(beam, greedy)


# ----------------------------------------------------------------------
# candidate ranking
# ----------------------------------------------------------------------
def test_rank_answers_matches_jax(models, monkeypatch):
    """Each sample's candidates ordered by the sum of its token losses, the
    ViT run once for all candidates."""
    jmodel, tmodel = models
    candidates = ["cat", "dog", "a big bird", "no"]
    images = np.random.RandomState(3).randn(3, 28, 28, 3).astype(np.float32)
    spec = JBatchSpec(seq_len=SEQ_LEN, num_img_tokens=jmodel.cfg.num_img_tokens,
                      max_answer_len=8)
    jb, tb = {}, {}
    for cand in candidates:
        built = j_build_train_batch(jmodel.tokenizer, [QUESTION] * 3, [cand] * 3, spec)
        jb[cand] = {"image": jnp.asarray(images), **{k: jnp.asarray(v) for k, v in built.items()}}
        tb[cand] = {"image": torch.from_numpy(images),
                    **{k: torch.from_numpy(v).long() for k, v in built.items()}}
    want = np.asarray(JM.rank_answers(jmodel.params, jmodel.cfg, jb))
    calls = []
    encode = TM.encode_img

    def spy(*args, **kw):
        calls.append(1)
        return encode(*args, **kw)

    monkeypatch.setattr(TM, "encode_img", spy)
    got = TM.rank_answers(tmodel.params, tmodel.cfg, tb).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 1 and got.shape == (3, len(candidates))


# ----------------------------------------------------------------------
# Chat
# ----------------------------------------------------------------------
def _vis(image):
    return np.asarray(image, np.float32)


def test_chat_matches_jax(models):
    """Two turns: the greedy answers and the conversation history equal the
    JAX ``Chat``'s; the stream's pieces join to the JAX stream's text."""
    jmodel, tmodel = models
    image = np.random.RandomState(4).randn(28, 28, 3).astype(np.float32)
    jchat, tchat = JCONV.Chat(jmodel, _vis), TCONV.Chat(tmodel, _vis)
    for chat in (jchat, tchat):
        chat.upload_img(image)
        chat.ask("what animal is this?")
    assert tchat.answer(max_new_tokens=5, seq_len=SEQ_LEN + 8) == \
        jchat.answer(max_new_tokens=5, seq_len=SEQ_LEN + 8)
    for chat in (jchat, tchat):
        chat.ask("and its colour?")
    got = list(tchat.stream_answer(max_new_tokens=5, seq_len=SEQ_LEN + 24))
    want = list(jchat.stream_answer(max_new_tokens=5, seq_len=SEQ_LEN + 24))
    assert got == want
    assert tchat.conv.messages == jchat.conv.messages
    with pytest.raises(RuntimeError, match="one image"):
        tchat.upload_img(image)
    tchat.reset()
    assert tchat.conv.messages == [] and tchat.image is None
    with pytest.raises(RuntimeError, match="upload_img"):
        tchat.answer()


# ----------------------------------------------------------------------
# sampling, the repetition penalty and min_length
# ----------------------------------------------------------------------
def _logits(rows=4, vocab=50, seed=5, scale=3.0):
    return (scale * np.random.RandomState(seed).randn(rows, vocab)).astype(np.float32)


@pytest.mark.parametrize("top_p,temperature", [(0.9, 1.0), (0.5, 0.7), (0.99, 1.3),
                                               (1e-6, 1.0)])
def test_nucleus_filter_matches_jax(monkeypatch, top_p, temperature):
    """The logits left in the nucleus (and their values after the
    temperature) equal those the JAX ``_select_token`` hands to its
    categorical draw."""
    logits = _logits()
    seen = []

    def capture(rng, filtered, axis=-1):
        seen.append(np.asarray(filtered))
        return jnp.argmax(filtered, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    JM._select_token(jnp.asarray(logits), do_sample=True, temperature=temperature,
                     top_p=top_p, rng=jax.random.PRNGKey(0))
    scaled = ieee_div(torch.from_numpy(logits), temperature)
    got = TM.nucleus_filter(scaled, top_p).numpy()
    np.testing.assert_array_equal(got, seen[0])
    kept = got > np.finfo(np.float32).min
    assert kept.any(axis=1).all()
    if top_p < 1e-3:
        assert (kept.sum(axis=1) == 1).all()


def test_repetition_penalty_matches_jax():
    logits = _logits(seed=6)
    counts = np.random.RandomState(7).randint(0, 3, logits.shape).astype(np.int32)
    for penalty in (1.0, 1.2, 0.8):
        want = np.asarray(JM._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts),
                                                       penalty))
        got = TM.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(counts),
                                          penalty)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("knobs", [
    {"repetition_penalty": 1.3},
    {"min_length": 4},
    {"repetition_penalty": 1.2, "min_length": 3},
    {"do_sample": True, "top_p": 1e-6, "temperature": 0.8, "min_length": 2},
])
def test_generate_knobs_match_jax(models, knobs):
    """Greedy tokens under the repetition penalty and ``min_length``, and
    sampling with one token left in the nucleus, equal the JAX package's;
    no row emits EOS before ``min_length`` tokens."""
    jmodel, tmodel = models
    jbatch, tbatch = _batches(jmodel, n=6, seed=8)
    want = np.asarray(JM.generate(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD,
                                  rng=jax.random.PRNGKey(3), **knobs))
    got = TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD, **knobs).numpy()
    np.testing.assert_array_equal(got, want)
    first_eos = [list(row).index(EOS) if EOS in row else STEPS for row in got]
    assert min(first_eos) >= knobs.get("min_length", 1) - 1
    greedy = np.asarray(JM.generate_greedy(jmodel.params, jmodel.cfg, jbatch, STEPS, EOS, PAD))
    assert (greedy == EOS).any()  # without the knobs, EOS does come early


def test_sampler_draws_from_the_filtered_softmax():
    """20000 draws of one row (seeded generator): each token's frequency is
    within 0.015 of its probability under the softmax of the filtered,
    tempered logits, and no token outside the nucleus is drawn."""
    row = _logits(rows=1, vocab=12, seed=9, scale=1.0)
    logits = torch.from_numpy(np.repeat(row, SAMPLE_DRAWS, axis=0))
    gen = torch.Generator()
    gen.manual_seed(11)
    top_p, temperature = 0.8, 0.9
    tokens = TM.select_token(logits, do_sample=True, temperature=temperature, top_p=top_p,
                             generator=gen).numpy()
    filtered = TM.nucleus_filter(ieee_div(torch.from_numpy(row), temperature), top_p)
    probs = torch.softmax(filtered, dim=-1)[0].numpy()
    freq = np.bincount(tokens, minlength=row.shape[1]) / SAMPLE_DRAWS
    assert np.abs(freq - probs).max() < SAMPLE_TOL
    assert freq[probs == 0].sum() == 0 and (probs == 0).any()


def test_sampling_is_reproducible_by_seed(models):
    _, tmodel = models
    _, tbatch = _batches(models[0], n=6, seed=10)

    def run(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return TM.generate(tmodel.params, tmodel.cfg, tbatch, STEPS, EOS, PAD, do_sample=True,
                           top_p=1.0, temperature=1.5, generator=gen)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


# ----------------------------------------------------------------------
# the Q-Former's text surface
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_query,causal,image", [(True, False, True), (True, True, True),
                                                    (False, True, False),
                                                    (True, False, False)])
def test_qformer_text_surface_matches_jax(with_query, causal, image):
    """``qformer_text_apply`` and ``qformer_lm_logits`` on the JAX
    ``init_qformer_text`` weights, with a padding mask (f32, atol 1e-5)."""
    jcfg = JQF.QFormerConfig.tiny(encoder_width=32)
    tcfg = TQF.QFormerConfig.tiny(encoder_width=32)
    tree = jax.tree.map(np.asarray, JQF.init_qformer_text(jax.random.PRNGKey(2), jcfg))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    rng = np.random.RandomState(12)
    ids = rng.randint(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    img = rng.randn(3, 5, 32).astype(np.float32) if image else None
    want = JQF.qformer_text_apply(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                  None if img is None else jnp.asarray(img), with_query, causal)
    got = TQF.qformer_text_apply(tparams, tcfg, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask), None if img is None else
                                 torch.from_numpy(img), with_query, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_logits = JQF.qformer_lm_logits(tree, jcfg, want)
    got_logits = TQF.qformer_lm_logits(tparams, tcfg, got)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5,
                               atol=1e-5)
    # the query path ignores the text leaves
    feats = rng.randn(2, 5, 32).astype(np.float32)
    np.testing.assert_allclose(
        TQF.qformer_apply(tparams, tcfg, torch.from_numpy(feats)).numpy(),
        np.asarray(JQF.qformer_apply(tree, jcfg, jnp.asarray(feats))), rtol=1e-5, atol=1e-5)


def test_text_leaves_carry_across(models):
    """A Q-Former with the text surface goes through ``params_from_jax``
    leaf for leaf, and the port's seeded ``init_qformer_text`` has the JAX
    tree's structure and shapes."""
    jmodel, _ = models
    ct = _cfgs(True)[1]
    tree = jax.tree.map(np.asarray, dict(jmodel.params))
    tree["qformer"] = jax.tree.map(np.asarray, JQF.init_qformer_text(
        jax.random.PRNGKey(4), jmodel.cfg.qformer))
    got = params_from_jax(tree, ct, "cpu")["qformer"]
    flat_want = jax.tree_util.tree_leaves_with_path(tree["qformer"])
    assert len(jax.tree_util.tree_leaves(got)) == len(flat_want)
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    ours = TQF.init_qformer_text(dataclasses.replace(ct.qformer), "cpu", seed=0)
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree["qformer"])
    assert jax.tree.map(lambda a: tuple(a.shape), ours) == shapes
