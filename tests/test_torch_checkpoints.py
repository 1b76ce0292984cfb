"""Port parity of checkpoint loading, on the CPU: the safetensors reader
gives ``safetensors.safe_open``'s tensors bit for bit; each converter gives
the JAX converter's tree bit for bit (both Q-Former dialects, the
position-table resample, the tied LM head, the f16 -> f32 -> bf16 cast
chain, the int8 layer kernels); ``from_config`` on tiny checkpoints in the
four upstream on-disk formats (a Vicuna HF directory as safetensors shards
or ``.bin`` shards, ``eva_vit_g.pth``, the BLIP-2 ``.pth``, the stage-2
``.pth``) gives the JAX ``from_config``'s tree exactly, and the certify and
eval agents on those weights write the JAX agents' rows and predictions at
sigma 0; ``HFTokenizer`` encodes and decodes as the JAX one; a checkpoint
URL resolves through the download cache."""

import json
import logging
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoints_gpu import (CKPT_GRID, L_D, L_HEADS, L_INTER, L_LAYERS, L_VOCAB,
                                        Q_D, VIT_D, VIT_GRID, _randn, blip2_checkpoint,
                                        eva_state_dict, llama_state_dict, qformer_state_dict)
from test_torch_launch import TIMING_KEYS, _rows, _summary, vqa  # noqa: F401

from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu.data import text as JT
from certifiedgpt_tpu.models import convert as JCV
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import qformer as JQF
from certifiedgpt_tpu.models.model_zoo import MiniGPT4Model as JModel
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit, quantize_llama
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common import utils as TU
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.data import text as TT
from certifiedgpt_tpu_torch.models import convert as TCV
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import model_zoo as TZ
from certifiedgpt_tpu_torch.models import qformer as TQF
from certifiedgpt_tpu_torch.models import safetensors_io as SIO

safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file  # noqa: E402

# ----------------------------------------------------------------------
# tree comparison
# ----------------------------------------------------------------------
def as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf.float().numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def torch_dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def assert_tree_equal(got, want, path="") -> None:
    """Same keys, dtypes, shapes and values (bit for bit after the bf16 ->
    f32 widening, which is exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got),
                                                                       sorted(want))
        for key in want:
            assert_tree_equal(got[key], want[key], f"{path}/{key}")
        return
    assert torch_dtype_name(got) == np.asarray(want).dtype.name, (path, got.dtype)
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)


# ----------------------------------------------------------------------
# tiny checkpoint files in the upstream layouts
# ----------------------------------------------------------------------
def train_tokenizer(vocab_total=None):
    """A BPE fast tokenizer trained on a small corpus (as
    ``tests/test_hf_tokenizer.py`` trains one); ``vocab_total`` pads its ids
    with added tokens so that every id a model of that vocabulary emits
    decodes."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    corpus = ["what is the animal in the picture?", "describe this image in detail please",
              "a cat sits on the mat", "the dog runs fast", "what is 0? what is 1? 2 3 4 5",
              "yes no maybe two three blue red <Img> </Img> [vqa] [INST]"] * 4
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    if vocab_total is None:  # the byte-level BPE of tests/test_hf_tokenizer.py
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        size = 400
    else:  # SentencePiece-like, as Vicuna's, within a tiny vocabulary
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        size = vocab_total // 2
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=size, special_tokens=["<unk>", "<s>", "</s>", "$$"]))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                                   eos_token="</s>")
    if vocab_total is not None:
        fast.add_tokens([f"<extra_{i}>" for i in range(len(fast), vocab_total)])
    return fast


def write_checkpoints(root, rng, llama_format="safetensors"):
    """The four checkpoint families at the tiny widths, in the upstream
    on-disk formats; returns their paths."""
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    root.mkdir(parents=True, exist_ok=True)
    torch.manual_seed(int(rng.randint(1 << 30)))
    hf = LlamaForCausalLM(HFLlamaConfig(
        vocab_size=L_VOCAB, hidden_size=L_D, intermediate_size=L_INTER,
        num_hidden_layers=L_LAYERS, num_attention_heads=L_HEADS, num_key_value_heads=L_HEADS,
        max_position_embeddings=128, rms_norm_eps=1e-6, tie_word_embeddings=False)).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.from_numpy(0.1 * rng.randn(*p.shape)).to(p.dtype))
    vicuna = root / f"vicuna_{llama_format}"
    if llama_format == "safetensors":  # sharded, with model.safetensors.index.json
        hf.half().save_pretrained(str(vicuna), safe_serialization=True, max_shard_size="100KB")
    else:
        hf.save_pretrained(str(vicuna), safe_serialization=False)
    train_tokenizer(L_VOCAB).save_pretrained(str(vicuna))
    paths = {"llama_model": str(vicuna), "eva_vit_g_pth": str(root / "eva_vit_g.pth"),
             "q_former_model": str(root / "blip2.pth"), "ckpt": str(root / "stage2.pth")}
    torch.save(eva_state_dict(rng), paths["eva_vit_g_pth"])
    torch.save(blip2_checkpoint(rng), paths["q_former_model"])
    torch.save({"model": {"llama_proj.weight": _randn(rng, L_D, Q_D),
                          "llama_proj.bias": _randn(rng, L_D),
                          "ln_vision.weight": 1 + _randn(rng, VIT_D),
                          "ln_vision.bias": _randn(rng, VIT_D)}}, paths["ckpt"])
    return paths


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    rng = np.random.RandomState(0)
    paths = write_checkpoints(root, rng, "safetensors")
    bin_dir = write_checkpoints(root / "bin", np.random.RandomState(1), "bin")["llama_model"]
    return {"safetensors": paths, "bin": dict(paths, llama_model=bin_dir)}


def jax_cfgs(dtype=None):
    extra = {} if dtype is None else {"dtype": dtype}
    return (JV.EvaViTConfig.tiny(**extra), JQF.QFormerConfig.tiny(encoder_width=VIT_D, **extra),
            JLM.LlamaConfig.tiny(**extra))


def torch_cfgs(dtype=None):
    extra = {} if dtype is None else {"dtype": dtype}
    return (TV.EvaViTConfig.tiny(**extra), TQF.QFormerConfig.tiny(encoder_width=VIT_D, **extra),
            TLM.LlamaConfig.tiny(**extra))


# ----------------------------------------------------------------------
# the safetensors reader
# ----------------------------------------------------------------------
def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("layout", ["file", "index", "shards"])
def test_safetensors_reader_matches_safe_open(tmp_path, layout):
    """Every dtype the loaders meet (F32, F16, BF16, I8, I64, an empty
    tensor) in one file, or split over two shards with and without
    ``model.safetensors.index.json``: the same bytes, dtype and shape as
    ``safetensors.safe_open``, and the same metadata."""
    rng = np.random.RandomState(3)
    tensors = {"w.f32": _randn(rng, 3, 5), "w.f16": _randn(rng, 7, dtype=torch.float16),
               "w.bf16": _randn(rng, 4, 6, dtype=torch.bfloat16),
               "w.i8": torch.from_numpy(rng.randint(-128, 128, (9,)).astype(np.int8)),
               "w.i64": torch.arange(-3, 5, dtype=torch.int64), "w.empty": torch.zeros(0, 3)}
    names = list(tensors)
    parts = {"model.safetensors": names} if layout == "file" else {
        "model-00001-of-00002.safetensors": names[:3],
        "model-00002-of-00002.safetensors": names[3:]}
    for file, keys in parts.items():
        save_file({k: tensors[k] for k in keys}, str(tmp_path / file), metadata={"format": "pt"})
    if layout == "index":
        weight_map = {k: f for f, keys in parts.items() for k in keys}
        (tmp_path / SIO.INDEX_FILE).write_text(json.dumps({"metadata": {},
                                                           "weight_map": weight_map}))
    state = SIO.SafetensorsDir(str(tmp_path))
    assert sorted(state) == sorted(names)
    for file, keys in parts.items():
        with safe_open(str(tmp_path / file), framework="pt") as ref, \
                SIO.SafetensorsFile(str(tmp_path / file)) as ours:
            assert sorted(ours.keys()) == sorted(ref.keys())
            assert ours.metadata() == ref.metadata()
            for key in keys:
                want = ref.get_tensor(key)
                for got in (ours.get_tensor(key), state[key]):
                    assert got.dtype == want.dtype and got.shape == want.shape, key
                    assert torch.equal(_bits(got), _bits(want)), key
    state.close()


def test_safetensors_reader_refuses_malformed_files(tmp_path):
    path = tmp_path / "x.safetensors"
    save_file({"a": torch.ones(4)}, str(path))
    data = path.read_bytes()
    (tmp_path / "short.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="data_offsets"):
        SIO.SafetensorsFile(str(tmp_path / "short.safetensors"))
    (tmp_path / "tiny.safetensors").write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="not a safetensors file"):
        SIO.SafetensorsFile(str(tmp_path / "tiny.safetensors"))
    empty = tmp_path / "empty_dir"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        SIO.SafetensorsDir(str(empty))


# ----------------------------------------------------------------------
# the converters against the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("prefix,head,quantize", [("model.", True, False), ("", False, False),
                                                  ("model.", True, True)])
def test_llama_converter_matches_jax(prefix, head, quantize):
    """ForCausalLM and bare LlamaModel keys, a tied LM head when
    ``lm_head.weight`` is absent, and int8 layer kernels (``quantize``
    against the JAX ``quantize_llama`` of the JAX conversion)."""
    sd = llama_state_dict(np.random.RandomState(4), prefix=prefix, head=head)
    jcfg, tcfg = jax_cfgs()[2], torch_cfgs()[2]
    want = JCV.convert_llama_state_dict(sd, jcfg)
    if quantize:
        want = quantize_llama(want)
    got = TCV.convert_llama_state_dict(sd, tcfg, quantize=quantize)
    assert_tree_equal(got, jax.tree.map(np.asarray, want))
    if not head:
        np.testing.assert_array_equal(got["lm_head"]["kernel"].numpy(),
                                      got["embed_tokens"]["embedding"].numpy().T)


@pytest.mark.parametrize("hf_style", [False, True])
def test_qformer_converter_matches_jax(hf_style):
    """Both key dialects, with the text branch, the embeddings and the LM
    head; the HF dialect carries no query tokens."""
    sd = qformer_state_dict(np.random.RandomState(5), hf_style=hf_style)
    want = JCV.convert_qformer_state_dict(sd, jax_cfgs()[1])
    got = TCV.convert_qformer_state_dict(sd, torch_cfgs()[1])
    assert_tree_equal(got, jax.tree.map(np.asarray, want))
    assert ("query_tokens" in got) != hf_style
    assert {"word_embeddings", "position_embeddings", "cls_transform", "cls_ln",
            "cls_bias"} <= set(got)
    assert {"int_txt", "out_txt", "ffn_ln_txt"} <= set(got["layers"]["layer_1"])


def test_qformer_converter_prefix_keeps_root_query_tokens():
    ckpt = blip2_checkpoint(np.random.RandomState(6))["model"]
    want = JCV.convert_qformer_state_dict(ckpt, jax_cfgs()[1], prefix="Qformer.bert.")
    got = TCV.convert_qformer_state_dict(ckpt, torch_cfgs()[1], prefix="Qformer.bert.")
    assert_tree_equal(got, jax.tree.map(np.asarray, want))
    np.testing.assert_array_equal(got["query_tokens"].numpy(), ckpt["query_tokens"].numpy())


@pytest.mark.parametrize("grid,quantize", [(CKPT_GRID, False), (CKPT_GRID, True),
                                           (VIT_GRID, False)])
def test_eva_vit_converter_matches_jax(grid, quantize):
    """An f16 ``eva_vit_g.pth`` with its position table on another grid
    (resampled bicubically) or the model's own, with and without the int8
    qkv/proj/fc1/fc2 kernels."""
    sd = eva_state_dict(np.random.RandomState(7), grid=grid)
    want = JCV.convert_eva_vit_state_dict(sd, jax_cfgs()[0])
    if quantize:
        want = quantize_eva_vit(want)
    got = TCV.convert_eva_vit_state_dict(sd, torch_cfgs()[0], quantize=quantize)
    assert_tree_equal(got, jax.tree.map(np.asarray, want))


def test_pos_embed_resample_matches_jax():
    """The 224-px grid (16 x 16) resampled to 448 px (32 x 32), as the real
    ``eva_vit_g.pth`` is, at a narrow width."""
    pos = _randn(np.random.RandomState(8), 1, 16 * 16 + 1, 24, dtype=torch.float16)
    want = JCV.interpolate_pos_embed(pos, 32 * 32)
    got = TCV.interpolate_pos_embed(pos, 32 * 32)
    assert got.shape == (1, 32 * 32 + 1, 24) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_cast_chain_matches_jax():
    """f16 (and bf16, f32) checkpoint tensors to the bf16 serving dtype:
    the port's f32 -> bf16 cast gives the JAX chain's bits (torch f16 ->
    numpy f32 -> ``jnp.asarray(dtype=bf16)``), and so does a direct
    ``.to(torch.bfloat16)`` from f16, including values that round in bf16,
    subnormals and the f16 range's ends."""
    rng = np.random.RandomState(9)
    f16 = torch.from_numpy(np.concatenate([
        rng.randn(4096).astype(np.float16), (rng.randn(256) * 1e-6).astype(np.float16),
        np.array([65504, -65504, 6.1e-5, 1.0009766, 0.0, -0.0], np.float16)]))
    want = np.asarray(jnp.asarray(f16.float().numpy(), dtype=jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(TCV._vec(f16, torch.bfloat16, "cpu").float().numpy(), want)
    np.testing.assert_array_equal(f16.to(torch.bfloat16).float().numpy(), want)
    for dtype in (torch.bfloat16, torch.float32):
        sd = llama_state_dict(rng, dtype=dtype)
        jwant = JCV.convert_llama_state_dict(sd, jax_cfgs(jnp.bfloat16)[2])
        got = TCV.convert_llama_state_dict(sd, torch_cfgs(torch.bfloat16)[2])
        assert_tree_equal(got, jax.tree.map(np.asarray, jwant))
    sd = eva_state_dict(rng)
    jwant = quantize_eva_vit(JCV.convert_eva_vit_state_dict(sd, jax_cfgs(jnp.bfloat16)[0]))
    got = TCV.convert_eva_vit_state_dict(sd, torch_cfgs(torch.bfloat16)[0], quantize=True)
    assert_tree_equal(got, jax.tree.map(np.asarray, jwant))


# ----------------------------------------------------------------------
# from_config on the four checkpoint families
# ----------------------------------------------------------------------
def _block(paths, quantize=False, **extra):
    return {"arch": "minigpt4", "model_size": "tiny", "quantize_llama": quantize,
            "quantize_vit": quantize, **paths, **extra}


@pytest.mark.parametrize("fmt,quantize", [("safetensors", False), ("safetensors", True),
                                          ("bin", False), ("bin", True)])
def test_from_config_matches_jax(ckpts, fmt, quantize):
    """Every tower from the files: the port's tree equals the JAX
    ``from_config``'s leaf for leaf (the Q-Former with its text branch), and
    the tokenizer is the directory's."""
    block = _block(ckpts[fmt], quantize)
    jmodel = JModel.from_config(block)
    model = TZ.MiniGPT4Model.from_config(block, "cpu")
    assert_tree_equal(model.params, jax.tree.map(np.asarray, jmodel.params))
    assert isinstance(model.tokenizer, TT.HFTokenizer)
    text = "<Img> what is the animal in the picture? [vqa]"
    assert model.tokenizer.encode(text) == jmodel.tokenizer.encode(text)
    assert (model.tokenizer.pad_token_id, model.tokenizer.eos_token_id) == \
        (jmodel.tokenizer.pad_token_id, jmodel.tokenizer.eos_token_id)
    assert model.tokenizer.vocab_size == jmodel.tokenizer.vocab_size == L_VOCAB


def test_bin_shards_read_like_from_pretrained(ckpts):
    """The ``.bin`` shards read directly give the state dict that the JAX
    package's ``AutoModelForCausalLM.from_pretrained`` gives."""
    from transformers import AutoModelForCausalLM

    path = ckpts["bin"]["llama_model"]
    ref = AutoModelForCausalLM.from_pretrained(path).state_dict()
    sd = {}
    for shard in sorted(os.listdir(path)):
        if shard.startswith("pytorch_model") and shard.endswith(".bin"):
            sd.update(TZ._torch_load(os.path.join(path, shard)))
    assert set(sd) == set(ref)
    for key, value in ref.items():
        assert torch.equal(sd[key], value), key


def test_from_config_loads_some_towers_and_skips_their_init(ckpts, monkeypatch):
    """Only the ViT and the stage-2 file: the loaded leaves equal the JAX
    package's, the other towers are drawn at random, and the ViT is never
    drawn first (``skip``)."""
    paths = {k: ckpts["safetensors"][k] for k in ("eva_vit_g_pth", "ckpt")}
    block = _block(paths, quantize=True)
    skips = []
    build = TZ.build_synthetic_params

    def spy(*args, **kw):
        skips.append(kw.get("skip"))
        return build(*args, **kw)

    monkeypatch.setattr(TZ, "build_synthetic_params", spy)
    model = TZ.MiniGPT4Model.from_config(block, "cpu")
    want = jax.tree.map(np.asarray, JModel.from_config(block).params)
    assert skips == [("vit",)]
    for key in ("vit", "llama_proj", "ln_vision"):
        assert_tree_equal(model.params[key], want[key], key)
    assert isinstance(model.tokenizer, TT.ByteTokenizer)
    assert model.params["llama"]["layers"]["q_proj"]["kernel_q"].dtype == torch.int8


def test_from_config_refuses_files_that_do_not_parse(tmp_path):
    bad = tmp_path / "eva_vit_g.pth"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        TZ.MiniGPT4Model.from_config(_block({"eva_vit_g_pth": str(bad)}), "cpu")
    empty = tmp_path / "vicuna"
    empty.mkdir()
    train_tokenizer(L_VOCAB).save_pretrained(str(empty))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        TZ.MiniGPT4Model.from_config(_block({"llama_model": str(empty)}), "cpu")


@pytest.mark.parametrize("agent", ["image_text_certify", "image_text_eval"])
def test_agents_on_loaded_weights_match_jax(vqa, ckpts, agent):  # noqa: F811
    """The certify agent's rows and summary and the eval agent's predictions
    and summary equal the JAX agents' at sigma 0, both agents building the
    model from the four files (the HF tokenizer included)."""
    def run(side):
        cfg = vqa(agent, f"{side}-loaded-{agent}", max_new_tokens=4, batch_size=4)
        cfg["model"] = _block(ckpts["safetensors"])
        if side == "jax":
            built = j_setup_agent(JConfig(cfg))
        else:
            built = setup_agent(Config(cfg), device="cpu")
        result = built.run()
        built.finalize()
        return result, vqa.root / "out" / f"{side}-loaded-{agent}"

    (j_res, j_out), (t_res, t_out) = run("jax"), run("torch")
    if agent == "image_text_certify":
        assert _rows(t_out / "certify_results.jsonl") == _rows(j_out / "certify_results.jsonl")
        assert _summary(t_out / "certify_summary.json") == _summary(j_out / "certify_summary.json")
    else:
        got = json.load(open(t_out / "eval_results.json"))
        want = json.load(open(j_out / "eval_results.json"))
        assert got == want and len(got["predictions"]) == 6
        assert {k: v for k, v in t_res.items() if k not in TIMING_KEYS} == \
            {k: v for k, v in j_res.items() if k not in TIMING_KEYS}


# ----------------------------------------------------------------------
# the tokenizer and the download cache
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "hf"
    train_tokenizer().save_pretrained(str(path))
    return str(path)


def test_hf_tokenizer_matches_jax(bpe_dir):
    """The byte-level BPE of ``tests/test_hf_tokenizer.py``: the same ids,
    specials (pad ``$$`` added where missing), vocabulary size, text and
    prompt batches as the JAX package's ``HFTokenizer``."""
    ours, ref = TT.HFTokenizer(bpe_dir), JT.HFTokenizer(bpe_dir)
    for name in ("pad_token_id", "bos_token_id", "eos_token_id", "vocab_size"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.tok.pad_token == "$$"
    for text in ("a cat sits on the mat", "<Img> [vqa] what is the animal?", "ünïcödé 42", ""):
        for specials in (False, True):
            ids = ours.encode(text, add_special_tokens=specials)
            assert ids == ref.encode(text, add_special_tokens=specials)
            assert ours.decode(ids) == ref.decode(ids)
            assert ours.decode(ids, False) == ref.decode(ids, False)
    instr = ["<Img><ImageHere></Img> [vqa] what is the animal in the picture?", "no image"]
    got = TT.build_gen_batch(ours, instr, TT.BatchSpec(48, 8))
    want = JT.build_gen_batch(ref, instr, JT.BatchSpec(48, 8))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_hf_tokenizer_without_transformers_raises(bpe_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        TT.HFTokenizer(bpe_dir)


def test_checkpoint_urls_download_once_into_the_cache(tmp_path, monkeypatch, caplog):
    """A URL is fetched once (``urllib.request.urlretrieve``, replaced here:
    no test reaches a network) into the cache and then read from it; a
    failed download is logged and the random init kept; a local path
    passes through."""
    fetched = []

    def fake_retrieve(url, target):
        fetched.append(url)
        with open(target, "wb") as handle:
            handle.write(b"weights")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    url = "https://example.com/ckpt/eva_vit_g.pth"
    assert TU.is_url(url) and not TU.is_url("/local/eva_vit_g.pth")
    assert TU.resolve_checkpoint("/local/eva_vit_g.pth") == "/local/eva_vit_g.pth"
    first = TU.resolve_checkpoint(url, cache_dir=str(tmp_path))
    again = TU.cached_download(url, cache_dir=str(tmp_path))
    assert first == again and fetched == [url] and open(first, "rb").read() == b"weights"
    assert os.path.basename(first).endswith("_eva_vit_g.pth")
    assert TU.get_abs_path("configs").endswith(os.path.join("certifiedgpt_tpu_torch", "configs"))

    def refuse(url, target):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(TU, "DEFAULT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(logging.getLogger("certifiedgpt_tpu_torch"), "propagate", True)
    with caplog.at_level("WARNING"):
        assert TZ._resolve("https://example.com/other.pth") is None
    assert "download failed" in caplog.text
