"""Port parity: the prefill's int8-KV attention with its cache write
(``certifiedgpt_tpu_torch/ops/attention.py::prefill_attention_kv8``) against
the JAX package's sequence on the CPU: ``quantize_rows`` of the S new k and v
rows, ``lax.dynamic_update_slice`` of the four cache buffers at the offset,
then ``multi_head_attention_kv8``; and a tiny model's prefill (in two parts,
the second at an offset) and greedy decode through ``llama_apply``, whose
prefill layers make one call of the op each."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops import attention as JA
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu.ops.quantization import quantize_llama as j_quantize_llama
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy
from certifiedgpt_tpu_torch.ops import attention as TA
from certifiedgpt_tpu_torch.ops import elementwise as TE
from certifiedgpt_tpu_torch.ops import quantization as TQ

# the output's relative Frobenius error against the JAX function, as
# tests/test_torch_kv8_decode.py holds the decode's: f32 q within 1e-5 (the
# f32 sums' order), bf16 q within 1e-2 (p rounds to bf16 in both, a sum's
# last ulp can move a rounding)
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
HEAD_DIM = 16
KV_HEADS = 2
NAMES = ("k", "v", "k_scale", "v_scale")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounded once, in JAX)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _cases():
    """B in {1, 3}, S in {2, 7}, the new rows at slot 0 or past it, g in {1,
    4}, f32 and bf16; a batch of 3 over a 40-slot cache, a batch of 1 over
    S + 5 slots."""
    for b in (1, 3):
        for s in (2, 7):
            t = 40 if b == 3 else s + 5
            for offset in (0, t - s - 1):
                for g in (1, 4):
                    for dtype in ("float32", "bfloat16"):
                        yield b, s, t, offset, g, dtype


def _old_cache(rng, b, t):
    old = [np.asarray(a) for a in JQ.quantize_rows(
        jnp.asarray(rng.randn(b, t, KV_HEADS, HEAD_DIM).astype(np.float32) * 2))]
    old += [np.asarray(a) for a in JQ.quantize_rows(
        jnp.asarray(rng.randn(b, t, KV_HEADS, HEAD_DIM).astype(np.float32)))]
    return dict(zip(("k", "k_scale", "v", "v_scale"), old))


def _decoder_mask(b, s, t, offset):
    """Query i at slot offset + i sees the slots up to its own; row 0
    left-padded by two slots, the last row of a batch fully masked."""
    valid = np.ones((b, t), bool)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    causal = np.arange(t)[None, :] <= offset + np.arange(s)[:, None]
    return causal[None, None] & valid[:, None, None, :]


def _check(b, s, t, offset, g, dtype, mask, seed):
    rng = np.random.RandomState(seed)
    h = KV_HEADS * g
    old = _old_cache(rng, b, t)
    jq, tq = _pair(rng.randn(b, s, h, HEAD_DIM), dtype)
    jk, tk = _pair(rng.randn(b, s, KV_HEADS, HEAD_DIM) * 3, dtype)
    jv, tv = _pair(rng.randn(b, s, KV_HEADS, HEAD_DIM), dtype)

    kq, ks = JQ.quantize_rows(jk)
    vq, vs = JQ.quantize_rows(jv)
    at = (0, offset, 0, 0)
    jcache = {name: lax.dynamic_update_slice(jnp.asarray(old[name]), upd, at)
              for name, upd in zip(NAMES, (kq, vq, ks, vs))}
    want = np.asarray(JA.multi_head_attention_kv8(
        jq, jcache["k"], jcache["k_scale"], jcache["v"], jcache["v_scale"],
        None if mask is None else jnp.asarray(mask)).astype(jnp.float32))

    cache = {name: torch.from_numpy(old[name].copy()) for name in NAMES}
    launches = TA.prefill_attention_kv8.launches
    got = TA.prefill_attention_kv8(tq, tk, tv, cache, offset,
                                   None if mask is None else torch.from_numpy(mask))
    assert TA.prefill_attention_kv8.launches == launches  # the CPU takes the plain version
    for name in NAMES:
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]),
                                      err_msg=name)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, HEAD_DIM)
    got = got.float().numpy()
    assert _rel(got, want) < REL_TOL[dtype]
    return got


@pytest.mark.parametrize("b,s,t,offset,g,dtype", list(_cases()))
def test_prefill_attention_kv8_matches_jax(b, s, t, offset, g, dtype):
    """The cache after the prefill (codes and scales) bit for bit the JAX
    sequence's, slots ``[offset, offset + S)`` written and every other slot
    kept; the output within ``REL_TOL`` under the decoder's mask; a fully
    masked batch row gives zeros."""
    got = _check(b, s, t, offset, g, dtype, _decoder_mask(b, s, t, offset),
                 1000 * t + 100 * s + 10 * offset + g + b)
    if b > 1:
        assert not got[-1].any()


@pytest.mark.parametrize("kind", ["none", "one_row", "keys", "random"])
def test_prefill_attention_kv8_masks_match_jax(kind):
    """The head-agnostic masks the kernel takes: none, one [1, 1, S, T] for
    every batch row, one [B, 1, 1, T] row for every query, any [B, 1, S,
    T]."""
    b, s, t, offset = 3, 7, 30, 11
    rng = np.random.RandomState(5)
    mask = {"none": None,
            "one_row": _decoder_mask(1, s, t, offset),
            "keys": rng.rand(b, 1, 1, t) < 0.6,
            "random": rng.rand(b, 1, s, t) < 0.6}[kind]
    _check(b, s, t, offset, 2, "bfloat16", mask, 7)


def test_prefill_attention_kv8_refuses_rows_outside_the_cache():
    cache = {"k": torch.zeros(1, 6, 2, 16, dtype=torch.int8),
             "v": torch.zeros(1, 6, 2, 16, dtype=torch.int8),
             "k_scale": torch.ones(1, 6, 2, 1), "v_scale": torch.ones(1, 6, 2, 1)}
    q, kv = torch.randn(1, 4, 2, 16), torch.randn(1, 4, 2, 16)
    for offset in (-1, 3):
        with pytest.raises(ValueError, match="outside"):
            TA.prefill_attention_kv8(q, kv, kv, cache, offset)
    with pytest.raises(ValueError, match="prefill_attention_kv8"):
        TA.prefill_attention_kv8(q, kv[:, :3], kv[:, :3], cache, 0)


def test_prefill_in_two_parts_and_greedy_decode_match_jax():
    """A tiny int8 model (W8A8 prefill, weight-only decode, int8 KV cache,
    two query heads a kv head): a left-padded prompt's prefill in two parts,
    the second at a cache offset, then greedy steps, each feeding the
    argmax token's embedding back. Each prefill layer calls
    ``prefill_attention_kv8`` once and quantizes no k or v row itself; the
    tokens equal the JAX package's, and the caches agree slot for slot."""
    kw = dict(act_quant=True, kv_quant=True, num_kv_heads=2)
    cfg_j = JLM.LlamaConfig.tiny(**kw)
    cfg_t = TLM.LlamaConfig.tiny(**kw)
    rng = np.random.RandomState(3)
    params = JLM.init_llama(jax.random.PRNGKey(2), cfg_j)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)
    params = jax.tree.map(np.asarray, j_quantize_llama(jax.tree.map(jnp.asarray, params)))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = TL.tree_map(tensor_from_numpy, params)
    table = np.asarray(params["embed_tokens"]["embedding"])

    b, s1, s2, new = 3, 5, 4, 4
    s = s1 + s2
    total = s + new
    mask = np.ones((b, s), np.int32)
    mask[2, :2] = 0
    cache_mask = np.concatenate([mask, np.ones((b, new), np.int32)], 1)
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    prompt = table[rng.randint(0, cfg_j.vocab_size, (b, s))]

    jcache = JLM.init_kv_cache(cfg_j, b, total)
    tcache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    # one compiled program a shape (the JAX block runs as one XLA program)
    japply = jax.jit(lambda p, x, m, pos, c, off: JLM.llama_apply(
        p, cfg_j, x, m, pos, kv_cache=c, cache_offset=off))
    calls, rows, fused = [], [], []
    real_op, real_rows = TA.prefill_attention_kv8, TQ.quantize_rows
    real_norm, real_silu = TE.add_rms_norm, TE.silu_mul

    def op_counted(*args, **kwargs):
        calls.append(args[4])
        return real_op(*args, **kwargs)

    def rows_counted(x, *args, **kwargs):
        rows.append(x.shape[-1])
        return real_rows(x, *args, **kwargs)

    def norm_counted(*args, quantize=False, **kwargs):
        fused.append(("norm", quantize))
        return real_norm(*args, quantize=quantize, **kwargs)

    def silu_counted(*args, quantize=False):
        fused.append(("silu", quantize))
        return real_silu(*args, quantize=quantize)

    for lo, hi in ((0, s1), (s1, s)):
        jl, _, jcache = japply(jparams, jnp.asarray(prompt[:, lo:hi]), jnp.asarray(cache_mask),
                               jnp.asarray(positions[:, lo:hi]), jcache, jnp.int32(lo))
        with mock.patch.object(TA, "prefill_attention_kv8", op_counted), \
                mock.patch.object(TQ, "quantize_rows", rows_counted), \
                mock.patch.object(TE, "add_rms_norm", norm_counted), \
                mock.patch.object(TE, "silu_mul", silu_counted):
            tl, _, tcache = TLM.llama_apply(
                tparams, cfg_t, torch.from_numpy(prompt[:, lo:hi]),
                torch.from_numpy(cache_mask), torch.from_numpy(positions[:, lo:hi]).long(),
                tcache, lo)
        assert calls == [lo] * cfg_t.num_layers
        # the q/k/v and gate/up inputs quantized once each by their norms,
        # the down input by silu_mul, the o input by quantize_rows: no k or
        # v row (head_dim wide) quantized outside the op
        assert rows == [cfg_t.hidden_size] * cfg_t.num_layers
        assert fused == [("norm", True), ("norm", True), ("silu", True)] * cfg_t.num_layers \
            + [("norm", False)]
        calls.clear()
        rows.clear()
        fused.clear()
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
    ttok = tl[:, -1].argmax(-1).numpy()
    jtokens, ttokens = [jtok], [ttok]
    next_pos = mask.sum(1)
    for step in range(new - 1):
        pos = (next_pos + step)[:, None].astype(np.int32)
        jl, _, jcache = japply(jparams, jnp.asarray(table[jtok][:, None]),
                               jnp.asarray(cache_mask), jnp.asarray(pos), jcache,
                               jnp.int32(s + step))
        tl, _, tcache = TLM.llama_apply(tparams, cfg_t, torch.from_numpy(table[ttok][:, None]),
                                        torch.from_numpy(cache_mask),
                                        torch.from_numpy(pos).long(), tcache, s + step)
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
        ttok = tl[:, -1].argmax(-1).numpy()
        jtokens.append(jtok)
        ttokens.append(ttok)
    np.testing.assert_array_equal(np.stack(ttokens, 1), np.stack(jtokens, 1))
    for name in NAMES:
        got, want = tcache[name][0].numpy(), np.asarray(jcache[name][0])
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            assert _rel(got, want) < 1e-5
