"""Port parity: the plain versions of the four int8 ops that the port runs
as hand-written CUDA kernels on the card and the JAX package leaves to XLA
(certifiedgpt_tpu_torch/ops/quantization.py: ``w8a8_epilogue``,
``int8_weight_forward``, ``quantize_rows``; ops/attention.py:
``multi_head_attention_kv8``), against the JAX functions on the CPU, and
the model-zoo surface (models/model_zoo.py) against the JAX one. The
kernels themselves run in tests/test_torch_kernels_gpu.py on a GPU."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu import registration  # noqa: F401 (the JAX registry)
from certifiedgpt_tpu.common.config import ConfigNode
from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.models import model_zoo as JZ
from certifiedgpt_tpu.ops import attention as JA
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import model_zoo as TZ
from certifiedgpt_tpu_torch.ops import attention as TA
from certifiedgpt_tpu_torch.ops import elementwise as TE
from certifiedgpt_tpu_torch.ops import quantization as TQ


def _bf16(a: np.ndarray):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _int8_kernel(rng, k, n):
    w = rng.randn(k, n).astype(np.float32) * 0.05
    q = JQ.quantize_kernel(jnp.asarray(w))
    return q, np.array(q["kernel_q"]), np.array(q["scale"])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_w8a8_epilogue_plain_matches_jax_bit_for_bit(bias):
    """From an int32 accumulator of the int8 product (exact: |acc| < 2^24),
    the plain epilogue's bf16 output is the JAX dense's W8A8 branch bit for
    bit, with and without the bias; the wrapper on CPU tensors is the
    plain version."""
    rng = np.random.RandomState(0)
    jx, tx = _bf16(rng.randn(6, 5, 64) * 2)
    jq, kq, sc = _int8_kernel(rng, 64, 48)
    params = {"kernel_q": jq["kernel_q"], "scale": jq["scale"]}
    b = None
    if bias:
        params["bias"] = jnp.asarray(rng.randn(48).astype(np.float32))
        b = torch.from_numpy(np.asarray(params["bias"]))
    want = JL.dense(params, jx, act_quant=True)
    xq, xs = TQ.quantize_rows(tx.reshape(-1, 64))
    acc = (xq.long() @ torch.from_numpy(kq).long()).int()
    assert int(acc.abs().max()) < 2 ** 24
    got = TQ._w8a8_epilogue_plain(acc, xs, torch.from_numpy(sc), b, torch.bfloat16)
    np.testing.assert_array_equal(_bits(got.reshape(6, 5, 48)), _jbits(want))
    wrapped = TQ.w8a8_epilogue(acc.float(), xs, torch.from_numpy(sc), b, torch.bfloat16)
    np.testing.assert_array_equal(_bits(wrapped), _bits(got))
    tparams = {"kernel_q": torch.from_numpy(kq), "scale": torch.from_numpy(sc)}
    if bias:
        tparams["bias"] = b
    np.testing.assert_array_equal(_bits(TL.dense(tparams, tx, act_quant=True)), _jbits(want))


def test_w8a8_gelu_epilogue_matches_jax_bit_for_bit():
    """The GELU branch: from JAX's own gelu row quantization, the plain
    epilogue gives ``w8a8_gelu_matmul``'s output bit for bit."""
    rng = np.random.RandomState(1)
    jx, _ = _bf16(rng.randn(7, 96) * 2)
    jq, kq, sc = _int8_kernel(rng, 96, 40)
    want = JQ.w8a8_gelu_matmul(jx, jq["kernel_q"], jq["scale"])
    xq, xs = (torch.from_numpy(np.asarray(a)) for a in JQ.gelu_quant_rows(jx))
    acc = (xq.long() @ torch.from_numpy(kq).long()).int()
    got = TQ._w8a8_epilogue_plain(acc, xs, torch.from_numpy(sc), None, torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weight_forward_plain_matches_jax(dtype):
    """The weight-only product against the JAX dense's weight-only branch:
    f32 within 1e-6 (summation order); bf16 within 2e-3 relative (the same
    sums in another order move a few output roundings one bf16 step)."""
    rng = np.random.RandomState(2)
    jq, kq, sc = _int8_kernel(rng, 128, 72)
    x = rng.randn(3, 5, 128).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(JL.dense({"kernel_q": jq["kernel_q"], "scale": jq["scale"]}, jx)
                      .astype(jnp.float32))
    for fn in (TQ._int8_weight_forward_plain, TQ.int8_weight_forward):
        got = fn(tx, torch.from_numpy(kq), torch.from_numpy(sc))
        assert got.dtype == tx.dtype and got.shape == (3, 5, 72)
        assert _rel(got.float().numpy(), want) < (1e-6 if dtype == "float32" else 2e-3)


@pytest.mark.parametrize("case", ["decode", "prefill", "gqa_decode", "gqa_prefill"])
def test_attention_kv8_plain_matches_jax(case):
    """Decode (one query row) and prefill rows, multi-head and grouped-query
    caches, the decoder's causal and validity mask with one fully masked
    batch row, which gives zeros: f32 q within 1e-5, bf16 q within 1e-2
    relative (the bf16 weights round as in JAX, the sums' order differs)."""
    rng = np.random.RandomState(3)
    sq = 1 if "decode" in case else 5
    h, h_kv = (8, 2) if "gqa" in case else (4, 4)
    b, t, d = 3, 9, 16
    k = rng.randn(b, t, h_kv, d).astype(np.float32)
    v = rng.randn(b, t, h_kv, d).astype(np.float32)
    kq, ks = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(v)))
    offset = t - sq - 1
    q_pos = offset + np.arange(sq)[:, None]
    valid = np.ones((b, t), bool)
    valid[0, :2] = False
    valid[-1] = False
    mask = (np.arange(t)[None, :] <= q_pos)[None, None] & valid[:, None, None, :]
    cache = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 1e-2)):
        x = rng.randn(b, sq, h, d).astype(np.float32)
        jx, tx = (_bf16(x) if dtype == "bfloat16" else (jnp.asarray(x), torch.from_numpy(x)))
        want = np.asarray(JA.multi_head_attention_kv8(
            jx, *(jnp.asarray(a) for a in (kq, ks, vq, vs)), jnp.asarray(mask))
            .astype(jnp.float32))
        for fn in (TA._multi_head_attention_kv8_plain, TA.multi_head_attention_kv8):
            got = fn(tx, *cache, torch.from_numpy(mask)).float().numpy()
            assert got.shape == (b, sq, h, d)
            assert _rel(got, want) < tol
            assert not got[-1].any()


def _reciprocal_rows(n, k, seed=0):
    """bf16 rows whose absmax ``a`` makes ``a * f32(1 / 127)`` differ from
    the IEEE division ``a / 127`` (as tests/test_torch_kernels_gpu.py)."""
    rng = np.random.RandomState(seed)
    cand = torch.from_numpy(np.abs(rng.randn(50 * n) * 3).astype(np.float32))
    cand = cand.to(torch.bfloat16).float().numpy()
    differ = cand / np.float32(127) != cand * (np.float32(1) / np.float32(127))
    amax = cand[differ][:n]
    assert amax.size == n
    x = rng.uniform(-1, 1, (n, k)).astype(np.float32) * amax[:, None]
    x[:, 0] = amax
    return torch.from_numpy(x).to(torch.bfloat16), amax


def test_quantize_rows_matches_jax_on_reciprocal_rows():
    """On the rows where the reciprocal product and the division differ
    (those the GPU test uses), the port's scales are the IEEE division's
    and its codes and scales equal the JAX package's bit for bit."""
    x, amax = _reciprocal_rows(64, 256)
    jq, js = JQ.quantize_rows(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    for fn in (TQ.quantize_rows, TQ._quantize_rows_plain):
        q, s = fn(x)
        np.testing.assert_array_equal(s.numpy(), (amax / np.float32(127))[:, None])
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_prefill_quantizes_a_shared_input_once():
    """The cached W8A8 prefill quantizes each layer's q/k/v input once and
    its gate/up input once, each inside the norm before them
    (``add_rms_norm``), the down input inside ``silu_mul``: one
    ``quantize_rows`` a layer, the o input's (its two cache writes are
    inside ``prefill_attention_kv8``, called once a layer), as do the
    training forward (autograd on: the fused ops as autograd Functions) and
    the same forward without autograd; a decode step none: its two cache
    writes are inside ``decode_attention_kv8``, called once a layer."""
    cfg = TLM.LlamaConfig.tiny(act_quant=True, kv_quant=True)
    params = TQ.quantize_llama(_tiny_llama_params(cfg))
    calls = []
    real = TQ.quantize_rows

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    b, s = 2, 5
    x = torch.randn(b, s, cfg.hidden_size)
    mask = torch.ones(b, s + 2, dtype=torch.int32)
    pos = torch.arange(s)[None].expand(b, s)
    decodes, prefills, fused = [], [], []
    real_decode, real_prefill = TA.decode_attention_kv8, TA.prefill_attention_kv8
    real_norm, real_silu = TE.add_rms_norm, TE.silu_mul

    def norm_counted(*args, quantize=False, **kwargs):
        fused.append(quantize)
        return real_norm(*args, quantize=quantize, **kwargs)

    def silu_counted(*args, quantize=False):
        fused.append(quantize)
        return real_silu(*args, quantize=quantize)

    def decode_counted(*args, **kwargs):
        decodes.append(args[0].shape)
        return real_decode(*args, **kwargs)

    def prefill_counted(*args, **kwargs):
        prefills.append(args[0].shape)
        return real_prefill(*args, **kwargs)

    with mock.patch.object(TQ, "quantize_rows", counted), \
            mock.patch.object(TA, "decode_attention_kv8", decode_counted), \
            mock.patch.object(TA, "prefill_attention_kv8", prefill_counted), \
            mock.patch.object(TE, "add_rms_norm", norm_counted), \
            mock.patch.object(TE, "silu_mul", silu_counted):
        cache = TLM.init_kv_cache(cfg, b, s + 2, "cpu")
        TLM.llama_apply(params, cfg, x, mask, pos, cache, 0)
        assert len(calls) == cfg.num_layers and not decodes
        assert len(prefills) == cfg.num_layers
        # q/k/v and gate/up codes from their norms, down's from silu_mul
        assert fused == [True, True, True] * cfg.num_layers + [False]
        calls.clear()
        prefills.clear()
        fused.clear()
        TLM.llama_apply(params, cfg, x[:, :1], mask, pos[:, :1] + s, cache, s)
        assert not calls and len(decodes) == cfg.num_layers and not prefills
        assert not any(fused)
        calls.clear()
        fused.clear()
        TLM.llama_apply(params, cfg, x.clone().requires_grad_(True), mask[:, :s], pos)
        assert len(calls) == cfg.num_layers
        assert fused == [True, True, True] * cfg.num_layers + [False]
        calls.clear()
        TLM.llama_apply(params, cfg, x, mask[:, :s], pos)
        assert len(calls) == cfg.num_layers


def _tiny_llama_params(cfg):
    from certifiedgpt_tpu_torch.models.model_zoo import _Init, _llama_params

    return _llama_params(_Init(0, "cpu"), cfg, False)


def test_int8_wrappers_count_no_launch_on_cpu():
    """On CPU tensors every wrapper takes its plain version: no launch."""
    before = (TQ.quantize_rows.launches, TQ.w8a8_epilogue.launches,
              TQ.int8_weight_forward.launches, TA.multi_head_attention_kv8.launches,
              TA.prefill_attention_kv8.launches)
    x = torch.randn(4, 16).to(torch.bfloat16)
    TQ.quantize_rows(x)
    TQ.w8a8_epilogue(torch.zeros(4, 8), torch.ones(4, 1), torch.ones(8))
    kq = TQ.int8_kernel_layout(torch.ones(16, 8, dtype=torch.int8))
    TQ.int8_weight_forward(x, kq, torch.ones(8))
    cache = torch.zeros(1, 3, 2, 16, dtype=torch.int8)
    scales = torch.ones(1, 3, 2, 1)
    TA.multi_head_attention_kv8(torch.randn(1, 1, 2, 16), cache, scales, cache, scales)
    TA.multi_head_attention_kv8(torch.randn(1, 2, 2, 16).to(torch.bfloat16), cache, scales,
                                cache, scales)
    assert (TQ.quantize_rows.launches, TQ.w8a8_epilogue.launches,
            TQ.int8_weight_forward.launches, TA.multi_head_attention_kv8.launches,
            TA.prefill_attention_kv8.launches) == before


def test_model_zoo_matches_jax():
    """``load_model_and_preprocess`` at ``model_size: tiny`` on the CPU: the
    same config and parameter tree (names, shapes) as the JAX package's, the
    same processed image and caption, and the same listing."""
    model, vis, text = TZ.load_model_and_preprocess("minigpt4", {"model_size": "tiny"},
                                                    device="cpu")
    jmodel, jvis, jtext = JZ.load_model_and_preprocess("minigpt4",
                                                       ConfigNode({"model_size": "tiny"}))
    assert model.cfg.llama.hidden_size == jmodel.cfg.llama.hidden_size == 64
    assert model.cfg.vit.depth == jmodel.cfg.vit.depth
    assert model.cfg.qformer.num_layers == jmodel.cfg.qformer.num_layers

    def shapes(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out.update(shapes(value, f"{prefix}{key}/"))
            else:
                out[prefix + key] = tuple(value.shape)
        return out

    assert shapes(model.params) == shapes(jmodel.params)
    image = np.random.RandomState(4).randint(0, 255, (40, 30, 3)).astype(np.uint8)
    for split in ("train", "eval"):
        assert type(vis[split]).__name__ == type(jvis[split]).__name__
        assert text[split]("A Cat!") == jtext[split]("A Cat!") == "a cat"
    np.testing.assert_allclose(np.asarray(vis["eval"](image)), np.asarray(jvis["eval"](image)),
                               atol=1e-6)
    assert list(TZ.model_zoo) == list(JZ.model_zoo) and len(TZ.model_zoo) == len(JZ.model_zoo)
    assert repr(TZ.model_zoo) == repr(JZ.model_zoo)
    with pytest.raises(KeyError, match="Unknown model"):
        TZ.load_model("no_such_model", device="cpu")
