"""The decoder block's fused elementwise ops (certifiedgpt_tpu_torch/ops/
elementwise.py) on the CPU: each plain version against the JAX chain it
replaces, and the restructured decoder (each residual added by the norm
that follows it) against the unrestructured chain and the JAX package.

Limits: the residual sum bit for bit. The rotary rows within one ulp of
the dtype when both sides read the port's tables (their cos/sin values are
within 6e-8 of JAX's, which alone moves an f32 row by up to 32 ulps where
the two terms cancel). The normalized rows within one ulp in bf16 and 8 in
f32 (XLA's CPU rsqrt and its sum order differ from PyTorch's: 5 ulps
measured). The SiLU x up rows within 3 ulps in bf16 and 4 in f32: the JAX
``silu`` is ``jax.nn.silu``, ``x * sigmoid(x)`` in the dtype, whose bf16
sigmoid rounds before the product, where the port's chain takes the SiLU
in f32 (2 ulps measured for the SiLU alone, 3 for the product). The int8
codes within one step on at most 1e-3 of the elements (2e-2 for SiLU x up,
whose rows differ from JAX's by more than an ulp in 4 % of the elements:
1.1e-2 measured; its codes of its own rows are JAX's ``quantize_rows``
bit for bit), row scales within 2^-7 relative (a one-ulp change of a row's
largest value moves its scale by one bf16 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu.ops.quantization import quantize_llama as j_quantize_llama
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy
from certifiedgpt_tpu_torch.ops import elementwise as E

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
EPS = 1e-6


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _within_ulp(got, want, dtype: str, ulps: float = 1.0) -> None:
    got, want = _f32(got), _f32(want)
    spacing = np.spacing(np.abs(want).astype(np.float32)) * (2.0 ** 16 if dtype == "bf16" else 1)
    assert np.all(np.abs(got - want) <= ulps * spacing), np.abs(got - want).max()


def _codes_close(got, want, share: float = 1e-3) -> None:
    (gq, gs), (wq, ws) = got, want
    diff = np.abs(gq.numpy().astype(np.int32) - np.asarray(wq).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= share
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=2.0 ** -7)


def _rows(rng, m: int, k: int, scale: float = 1.0) -> np.ndarray:
    """``m`` rows of width ``k``, the last one zeros."""
    a = (scale * rng.randn(m, k)).astype(np.float32)
    a[-1] = 0.0
    return a


@pytest.mark.parametrize("k", [64, 4096])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "first_layer"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_add_rms_norm_plain_matches_jax(dtype, residual, k):
    """``x + y`` then ``rms_norm`` then ``quantize_rows``: the sum bit for
    bit, the normalized rows within one ulp, the codes and scales within
    the module's limits."""
    rng = np.random.RandomState(k + residual)
    x, xj = _pair(_rows(rng, 9, k, 3.0), dtype)
    y, yj = _pair(_rows(rng, 9, k), dtype) if residual else (None, None)
    scale, scale_j = _pair((1.0 + 0.1 * rng.randn(k)).astype(np.float32), dtype)
    sj = xj + yj if residual else xj
    hj = JL.rms_norm({"scale": scale_j}, sj, EPS)
    s, h = E.add_rms_norm(x, y, scale, EPS)
    s2, codes = E.add_rms_norm(x, y, scale, EPS, quantize=True)
    assert s.dtype == h.dtype == x.dtype and h.shape == x.shape
    np.testing.assert_array_equal(_f32(s), _f32(sj))
    np.testing.assert_array_equal(_f32(s2), _f32(sj))
    if not residual:
        assert s is x
    _within_ulp(h, hj, dtype, 1 if dtype == "bf16" else 8)
    if not residual:
        assert not h[-1].any()
    _codes_close(codes, JQ.quantize_rows(hj))
    assert codes[0].dtype == torch.int8 and codes[1].shape == (9, 1)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rotary_plain_matches_jax(dtype):
    """q (4 heads) and k (2 kv heads) rotated at left-padded positions,
    from the kept tables: within one ulp of the JAX ``apply_rotary`` on the
    same tables, which are within 6e-8 of JAX's."""
    rng = np.random.RandomState(3)
    b, s, dh, max_len = 3, 7, 16, 64
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32) + np.array([[0], [0], [40]])
    q, qj = _pair(rng.randn(b, s, 4, dh).astype(np.float32), dtype)
    k, kj = _pair(rng.randn(b, s, 2, dh).astype(np.float32), dtype)
    tables = E.rotary_tables(dh, max_len, 10000.0)
    assert E.rotary_tables(dh, max_len, 10000.0, "cpu") is tables
    cos_j, sin_j = JL.rotary_tables(dh, max_len, 10000.0)
    for got, want in zip(tables, (cos_j, sin_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=6e-8)
    cos_j, sin_j = (jnp.asarray(t.numpy()) for t in tables)
    for pos in (torch.from_numpy(positions).long(), torch.from_numpy(positions)):
        rq, rk = E.rotary(q, k, *tables, pos)
        assert rq.dtype == q.dtype and rk.shape == k.shape
        pj = jnp.asarray(positions)
        _within_ulp(rq, JL.apply_rotary(qj, cos_j, sin_j, pj), dtype)
        _within_ulp(rk, JL.apply_rotary(kj, cos_j, sin_j, pj), dtype)
        # the kept tables give the per-call tables' rows bit for bit
        np.testing.assert_array_equal(rq.float().numpy(), TL.apply_rotary(
            q, *TL.rotary_tables(dh, max_len), pos).float().numpy())


@pytest.mark.parametrize("k", [128, 11008])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_silu_mul_plain_matches_jax(dtype, k):
    """``silu(gate) * up``, with and without its ``quantize_rows``, against
    the JAX chain: within the module's limits."""
    rng = np.random.RandomState(k)
    gate, gate_j = _pair(_rows(rng, 5, k, 3.0), dtype)
    up, up_j = _pair(_rows(rng, 5, k), dtype)
    want = JL.silu(gate_j) * up_j
    got = E.silu_mul(gate, up)
    assert got.dtype == gate.dtype and got.shape == gate.shape
    _within_ulp(got, want, dtype, 3 if dtype == "bf16" else 4)
    assert not got[-1].any()
    xq, xs = E.silu_mul(gate, up, quantize=True)
    _codes_close((xq, xs), JQ.quantize_rows(want), share=2e-2)
    jq, js = JQ.quantize_rows(jnp.asarray(got.float().numpy()).astype(DTYPES[dtype][1]))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js))


def _tiny(serving: bool):
    kw = dict(act_quant=serving, kv_quant=serving, num_kv_heads=2)
    cfg_j, cfg_t = JLM.LlamaConfig.tiny(**kw), TLM.LlamaConfig.tiny(**kw)
    rng = np.random.RandomState(1)
    params = JLM.init_llama(jax.random.PRNGKey(0), cfg_j)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a)).astype(np.float32),
                          params)
    if serving:
        params = jax.tree.map(np.asarray, j_quantize_llama(jax.tree.map(jnp.asarray, params)))
    return cfg_j, cfg_t, params, rng


@pytest.mark.parametrize("serving", [True, False], ids=["int8_kv8_w8a8", "float"])
def test_restructured_decoder_matches_the_chain_and_jax(serving):
    """A prefill of a left-padded prompt and two decode steps through the
    restructured decoder (each residual added by the next norm, the fused
    ops' plain versions) where autograd does not record equal, bit for bit,
    the same calls where it records (the fused ops as autograd Functions:
    the training forward's path), logits, hidden states and cache alike. So
    does the forward without a cache. (The decoder against the JAX decoder:
    tests/test_torch_llama.py and test_torch_minigpt4.py; its gradients:
    tests/test_torch_decoder_grads.py.)"""
    cfg_j, cfg_t, params, rng = _tiny(serving)
    tparams = TL.tree_map(tensor_from_numpy, params)
    b, s, new = 3, 6, 2
    total = s + new
    mask = np.ones((b, s), np.int32)
    mask[1, :2] = 0
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    cache_mask = torch.from_numpy(np.concatenate([mask, np.ones((b, new), np.int32)], 1))
    calls = [(rng.randn(b, s, cfg_j.hidden_size).astype(np.float32), positions, 0)]
    for t in range(new):
        calls.append((rng.randn(b, 1, cfg_j.hidden_size).astype(np.float32),
                      (mask.sum(1) + t)[:, None].astype(np.int32), s + t))
    fused_cache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    chain_cache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    for x, pos, offset in calls:
        tpos = torch.from_numpy(pos).long()
        with torch.no_grad():
            fl, fh, _ = TLM.llama_apply(tparams, cfg_t, torch.from_numpy(x), cache_mask, tpos,
                                        fused_cache, offset)
        with torch.enable_grad():
            emb = torch.from_numpy(x).requires_grad_(True)
            cl, ch, _ = TLM.llama_apply(tparams, cfg_t, emb, cache_mask, tpos, chain_cache,
                                        offset)
        assert cl.requires_grad and ch.requires_grad
        np.testing.assert_array_equal(fl.numpy(), cl.detach().numpy())
        np.testing.assert_array_equal(fh.numpy(), ch.detach().numpy())
    for name in fused_cache:
        for got, want in zip(fused_cache[name], chain_cache[name]):
            np.testing.assert_array_equal(got.numpy(), want.detach().numpy())

    # the forward without a cache (a validation batch): fused under no_grad
    x = torch.from_numpy(calls[0][0])
    valid, tpos = torch.from_numpy(mask), torch.from_numpy(positions).long()
    with torch.no_grad():
        fl, fh, none = TLM.llama_apply(tparams, cfg_t, x, valid, tpos)
    cl, ch, _ = TLM.llama_apply(tparams, cfg_t, x.clone().requires_grad_(True), valid, tpos)
    assert none is None
    np.testing.assert_array_equal(fl.numpy(), cl.detach().numpy())
    np.testing.assert_array_equal(fh.numpy(), ch.detach().numpy())


def test_the_serving_path_runs_the_fused_ops():
    """Without autograd the decoder calls each fused op once where the
    chain ran: two norms a layer and the final one, one rotary and one
    SiLU x up a layer; a forward autograd records calls the same ones."""
    from unittest import mock

    cfg_j, cfg_t, params, rng = _tiny(True)
    tparams = TL.tree_map(tensor_from_numpy, params)
    seen = []

    def spy(name, fn):
        def call(*args, **kwargs):
            seen.append((name, kwargs.get("quantize", False)))
            return fn(*args, **kwargs)
        return mock.patch.object(E, name, call)

    x = torch.from_numpy(rng.randn(2, 5, cfg_t.hidden_size).astype(np.float32))
    valid = torch.ones((2, 5), dtype=torch.int32)
    pos = torch.arange(5)[None].expand(2, 5)
    with spy("add_rms_norm", E.add_rms_norm), spy("rotary", E.rotary), \
            spy("silu_mul", E.silu_mul):
        with torch.no_grad():
            TLM.llama_apply(tparams, cfg_t, x, valid, pos)
        layer = [("add_rms_norm", True), ("rotary", False), ("add_rms_norm", True),
                 ("silu_mul", True)]
        assert seen == layer * cfg_t.num_layers + [("add_rms_norm", False)]
        seen.clear()
        logits, _, _ = TLM.llama_apply(tparams, cfg_t, x.requires_grad_(True), valid, pos)
        assert logits.requires_grad
        assert seen == layer * cfg_t.num_layers + [("add_rms_norm", False)]
