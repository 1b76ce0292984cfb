"""Port parity for the slice as a whole, on the CPU: a tiny MiniGPT-4 with
every serving knob of the shipped certify configs (cls-split ViT at 224 px
with int8 kernels and W8A8 activations, int8 decoder, W8A8 prefill, int8
KV cache, early exit) gives the JAX package's greedy tokens, and at
sigma = 0 the smoothed classifier's label counts and the certificate
(label, radius) equal the JAX run's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.data.text import ByteTokenizer as JByteTokenizer
from certifiedgpt_tpu.data.text import BatchSpec as JBatchSpec
from certifiedgpt_tpu.data.text import build_gen_batch as j_build_gen_batch
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.models import qformer as JQF
from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit, quantize_llama
from certifiedgpt_tpu.smoothing import classifier as JC
from certifiedgpt_tpu.smoothing.smoothing import Smooth as JSmooth
from certifiedgpt_tpu_torch.agents.certify import certify_item
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models import qformer as TQF
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_model
from certifiedgpt_tpu_torch.smoothing import classifier as TC
from certifiedgpt_tpu_torch.smoothing.smoothing import Smooth

QUESTION = "<Img><ImageHere></Img> what animal?"
SEQ_LEN = 48
EOS_BIAS = 2.0  # some rows emit EOS early, so early exit has work to skip


def _serving_cfgs():
    vit = dict(img_size=224, attn_impl="flash_cls", act_quant=True)
    llama = dict(act_quant=True, kv_quant=True)
    cj = JM.MiniGPT4Config.tiny(
        vit=JV.EvaViTConfig.tiny(**vit),
        qformer=JQF.QFormerConfig.tiny(encoder_width=32),
        llama=JLM.LlamaConfig.tiny(**llama),
    )
    ct = TM.MiniGPT4Config.tiny(
        vit=TV.EvaViTConfig.tiny(**vit),
        qformer=TQF.QFormerConfig.tiny(encoder_width=32),
        llama=TLM.LlamaConfig.tiny(**llama),
    )
    return cj, ct


@pytest.fixture(scope="module")
def models():
    cj, ct = _serving_cfgs()
    params = JM.init_minigpt4(jax.random.PRNGKey(0), cj)
    params["vit"] = quantize_eva_vit(params["vit"])
    params["llama"] = quantize_llama(params["llama"])
    bias = np.zeros((cj.llama.vocab_size,), np.float32)
    bias[JByteTokenizer.eos_token_id] = EOS_BIAS
    params["llama"]["lm_head"]["bias"] = jnp.asarray(bias)
    tree = jax.tree.map(np.asarray, params)
    jmodel = JModel(cj, jax.tree.map(jnp.asarray, tree), JByteTokenizer())
    tmodel = MiniGPT4Model(ct, params_from_jax(tree, ct, "cpu"), ByteTokenizer())
    return jmodel, tmodel


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 224, 224, 3).astype(np.float32)


@pytest.mark.parametrize("early_exit", [True, False])
def test_greedy_tokens_match_jax(models, early_exit):
    jmodel, tmodel = models
    spec = JBatchSpec(seq_len=SEQ_LEN, num_img_tokens=jmodel.cfg.num_img_tokens)
    prompt = j_build_gen_batch(jmodel.tokenizer, [QUESTION] * 6, spec)
    images = _images(6)
    jbatch = {k: jnp.asarray(v) for k, v in prompt.items()}
    jbatch["image"] = jnp.asarray(images)
    want = np.asarray(JM.generate_greedy(jmodel.params, jmodel.cfg, jbatch, 6, 2, 0,
                                         early_exit=early_exit))
    tbatch = {k: torch.from_numpy(v).long() for k, v in prompt.items()}
    tbatch["image"] = torch.from_numpy(images)
    got = TM.generate_greedy(tmodel.params, tmodel.cfg, tbatch, 6, 2, 0,
                             early_exit=early_exit).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 2).any() and (want == 0).any()  # EOS and post-EOS pad occur


def test_sigma_zero_certificate_matches_jax(models):
    jmodel, tmodel = models
    vocab_answers = ["cat", "dog", "bird"]
    image = _images(1, seed=3)[0]
    common = dict(mc_batch=4, max_new_tokens=3, seq_len=SEQ_LEN, early_exit=True)
    j_fn = JC.make_sample_fn(jmodel, QUESTION, JC.AnswerVocabulary(vocab_answers), 0.0,
                             **common)
    t_vocab = TC.AnswerVocabulary(vocab_answers)
    t_fn = TC.make_sample_fn(tmodel, QUESTION, t_vocab, 0.0, **common)
    np.testing.assert_array_equal(t_fn(image, 10, seed=5), j_fn(image, 10, seed=5))
    j_cert = JSmooth(j_fn, t_vocab.num_classes, 0.0).certify(image, 4, 8, 0.001, seed=11)
    t_cert = Smooth(t_fn, t_vocab.num_classes, 0.0).certify(image, 4, 8, 0.001, seed=11)
    assert t_cert == j_cert


def test_sample_fn_stops_on_a_prefix_of_the_full_run(models):
    """Chunk noise is keyed by (seed, chunk) alone: a run stopped early sees
    exactly the first draws of the full run."""
    _, tmodel = models
    vocab = TC.AnswerVocabulary(["cat", "dog"])
    fn = TC.make_sample_fn(tmodel, QUESTION, vocab, 0.5, mc_batch=4, max_new_tokens=2,
                           seq_len=SEQ_LEN)
    image = _images(1, seed=4)[0]
    full = fn(image, 12, seed=7)
    calls = []
    stopped = fn(image, 12, seed=7,
                 should_stop=lambda labels: (calls.append(labels.size), len(calls) >= 2)[1])
    assert stopped.size == 8
    np.testing.assert_array_equal(stopped, full[:8])


def test_certify_item_row_on_synthetic_model():
    """The chip script's entry point on a seeded synthetic tiny model."""
    _, ct = _serving_cfgs()
    model = build_synthetic_model(ct, "cpu", seed=0)
    assert model.device == torch.device("cpu")
    assert model.params["llama"]["layers"]["q_proj"]["kernel_q"].dtype == torch.int8
    run = dict(noise_level=0.25, certify_n0=4, certify_n=12, mc_batch=4, max_new_tokens=3,
               seq_len=SEQ_LEN, early_exit=True, early_abstain=True, early_stop_radius=1.0,
               seed=42)
    row = certify_item(model, _images(1)[0], QUESTION, ["cat", "dog"], run, index=3,
                       question_id=17)
    assert set(row) == {"index", "question_id", "label", "answer", "radius", "correct",
                        "abstain", "seconds", "sigma", "n0", "n", "draws"}
    assert row["index"] == 3 and row["question_id"] == 17 and row["sigma"] == 0.25
    assert row["abstain"] == (row["label"] == -1)
    assert 4 < row["draws"] <= 16 and row["radius"] >= 0.0
    with pytest.raises(ValueError, match="candidate answers"):
        certify_item(model, _images(1)[0], QUESTION, [], run, index=0)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("block", [
    {"model_size": "tiny"},
    {"model_size": "tiny", "quantize_vit": True, "quantize_llama": True, "act_quant": True,
     "kv_quant": True, "vit_attn_impl": "flash_custom", "image_size": 224, "init_seed": 3},
    {"model_size": "tiny", "max_position_embeddings": 256, "remat": False},
], ids=["float", "serving", "positions"])
def test_from_config_matches_jax(block):
    """The synthetic half of MiniGPT4Model.from_config on a plain mapping:
    the config's fields and the parameter tree's keys, shapes and dtypes
    equal the JAX package's on the same mapping (the values are other
    seeded draws)."""
    jmodel = JModel.from_config(block)
    tmodel = MiniGPT4Model.from_config(block, device="cpu")
    for part in ("vit", "qformer", "llama"):
        tcfg, jcfg = getattr(tmodel.cfg, part), getattr(jmodel.cfg, part)
        for field in dataclasses.fields(tcfg):
            want = getattr(jcfg, field.name)
            got = getattr(tcfg, field.name)
            if field.name == "dtype":
                want, got = np.dtype(want).name, _dtype_name(got)
            assert got == want, (part, field.name)
    assert (tmodel.cfg.max_txt_len, tmodel.cfg.max_context_len) == (
        jmodel.cfg.max_txt_len, jmodel.cfg.max_context_len)
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in _flat(jmodel.params)}
    got = {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in _flat(tmodel.params)}
    assert got == want


def test_from_config_refuses_remat():
    """remat was refused before the training forward was ported; now the
    knob and its two companions are read as the JAX package reads them,
    and rematerialization changes no logit of the training forward."""
    block = {"model_size": "tiny", "remat": True, "remat_policy": "dots", "remat_every": 2}
    model = MiniGPT4Model.from_config(block, "cpu")
    jcfg = JModel.from_config(block).cfg.llama
    assert (model.cfg.llama.remat, model.cfg.llama.remat_policy, model.cfg.llama.remat_every) \
        == (jcfg.remat, jcfg.remat_policy, jcfg.remat_every) == (True, "dots", 2)
    plain = MiniGPT4Model.from_config({"model_size": "tiny"}, "cpu")
    assert plain.cfg.llama.remat is False
    emb = torch.randn(2, 10, model.cfg.llama.hidden_size, requires_grad=True)
    mask = torch.ones(2, 10, dtype=torch.int32)
    pos = torch.arange(10).expand(2, 10)
    llama = model.params["llama"]
    with_remat, _, _ = TLM.llama_apply(llama, model.cfg.llama, emb, mask, pos)
    without, _, _ = TLM.llama_apply(llama, plain.cfg.llama, emb, mask, pos)
    assert torch.equal(with_remat, without)


def test_from_config_checkpoint_paths(tmp_path, caplog, monkeypatch):
    """An existing checkpoint path is loaded (an ``eva_vit_g.pth`` in the
    upstream layout, as the JAX package converts it); a missing one is
    logged and the random init kept."""
    import logging

    from certifiedgpt_tpu.models.convert import convert_eva_vit_state_dict
    from test_torch_checkpoints import assert_tree_equal, eva_state_dict

    # an agent built earlier in this process set up the port's logger,
    # which stops propagation to the root logger that caplog reads
    monkeypatch.setattr(logging.getLogger("certifiedgpt_tpu_torch"), "propagate", True)
    ckpt = tmp_path / "eva_vit_g.pth"
    sd = eva_state_dict(np.random.RandomState(0))
    torch.save(sd, ckpt)
    model = MiniGPT4Model.from_config({"model_size": "tiny", "eva_vit_g_pth": str(ckpt)}, "cpu")
    want = convert_eva_vit_state_dict(sd, JModel.from_config({"model_size": "tiny"}).cfg.vit)
    assert_tree_equal(model.params["vit"], jax.tree.map(np.asarray, want))
    with caplog.at_level("WARNING"):
        model = MiniGPT4Model.from_config(
            {"model_size": "tiny", "llama_model": str(tmp_path / "missing")}, "cpu")
    assert "not found" in caplog.text and model.device == torch.device("cpu")


def test_params_from_jax_checks_widths(models):
    jmodel, _ = models
    _, ct = _serving_cfgs()
    tree = jax.tree.map(np.asarray, jmodel.params)
    wrong = dataclasses.replace(ct, llama=dataclasses.replace(ct.llama, hidden_size=48))
    with pytest.raises(ValueError, match="llama_proj"):
        params_from_jax(tree, wrong, "cpu")
    bf16 = {"a": np.asarray(jnp.ones((2,), jnp.bfloat16))}
    from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy

    assert tensor_from_numpy(bf16["a"]).dtype == torch.bfloat16
