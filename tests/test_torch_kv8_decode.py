"""Port parity: the decode step's int8-KV attention with its cache write
(``certifiedgpt_tpu_torch/ops/attention.py::decode_attention_kv8``) against
the JAX package's sequence on the CPU: ``quantize_rows`` of the step's k and
v, ``lax.dynamic_update_slice`` of the four cache buffers at the offset,
then ``multi_head_attention_kv8``; and a tiny model's greedy decode through
``llama_apply``, whose decode steps take the op."""

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

# the output's relative Frobenius error against the JAX function, as
# tests/test_torch_int8_ops.py holds the int8-KV attention: f32 q within
# 1e-5 (the f32 sums' order), bf16 q within 1e-2 (p rounds to bf16 in both,
# a sum's last ulp can move a rounding)
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
    for b in (1, 3):
        for t in (1, 17, 40):
            for offset in sorted({0, t // 2, t - 1}):
                for g in (1, 4):
                    for dtype in ("float32", "bfloat16"):
                        yield b, t, offset, g, dtype


@pytest.mark.parametrize("b,t,offset,g,dtype", list(_cases()))
def test_decode_attention_kv8_matches_jax(b, t, offset, g, dtype):
    """The cache after the step (codes and scales) bit for bit the JAX
    sequence's, slot ``offset`` written and every other slot kept; the
    output within ``REL_TOL``; the decoder's mask (slots after the offset
    hidden, row 0 left-padded by up to two slots, the last row of a batch
    fully masked, which gives zeros)."""
    rng = np.random.RandomState(1000 * t + 10 * offset + g + b)
    h = KV_HEADS * g
    old = [np.asarray(a) for a in JQ.quantize_rows(
        jnp.asarray(rng.randn(b, t, KV_HEADS, HEAD_DIM).astype(np.float32) * 2))]
    old += [np.asarray(a) for a in JQ.quantize_rows(
        jnp.asarray(rng.randn(b, t, KV_HEADS, HEAD_DIM).astype(np.float32)))]
    old = dict(zip(("k", "k_scale", "v", "v_scale"), old))
    jq, tq = _pair(rng.randn(b, 1, h, HEAD_DIM), dtype)
    jk, tk = _pair(rng.randn(b, 1, KV_HEADS, HEAD_DIM) * 3, dtype)
    jv, tv = _pair(rng.randn(b, 1, KV_HEADS, HEAD_DIM), dtype)
    valid = np.ones((b, t), bool)
    valid[0, :min(2, offset)] = False
    if b > 1:
        valid[-1] = False
    mask = (np.arange(t) <= offset)[None, None, None, :] & valid[:, None, None, :]

    kq, ks = JQ.quantize_rows(jk)
    vq, vs = JQ.quantize_rows(jv)
    at = (0, offset, 0, 0)
    jcache = {name: lax.dynamic_update_slice(jnp.asarray(old[name]), upd, at)
              for name, upd in zip(NAMES, (kq, vq, ks, vs))}
    want = np.asarray(JA.multi_head_attention_kv8(
        jq, jcache["k"], jcache["k_scale"], jcache["v"], jcache["v_scale"],
        jnp.asarray(mask)).astype(jnp.float32))

    cache = {name: torch.from_numpy(old[name].copy()) for name in NAMES}
    launches = TA.decode_attention_kv8.launches
    got = TA.decode_attention_kv8(tq, tk, tv, cache, offset, torch.from_numpy(mask))
    assert TA.decode_attention_kv8.launches == launches  # the CPU takes the plain version
    for name in NAMES:
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]),
                                      err_msg=name)
    assert got.dtype == tq.dtype and got.shape == (b, 1, h, HEAD_DIM)
    got = got.float().numpy()
    assert _rel(got, want) < REL_TOL[dtype]
    if b > 1:
        assert not got[-1].any()


def test_decode_attention_kv8_refuses_a_slot_outside_the_cache():
    cache = {"k": torch.zeros(1, 4, 2, 16, dtype=torch.int8),
             "v": torch.zeros(1, 4, 2, 16, dtype=torch.int8),
             "k_scale": torch.ones(1, 4, 2, 1), "v_scale": torch.ones(1, 4, 2, 1)}
    q, kv = torch.randn(1, 1, 2, 16), torch.randn(1, 1, 2, 16)
    for offset in (-1, 4):
        with pytest.raises(ValueError, match="outside"):
            TA.decode_attention_kv8(q, kv, kv, cache, offset)
    with pytest.raises(ValueError, match="one query row"):
        TA.decode_attention_kv8(torch.randn(1, 2, 2, 16), kv, kv, cache, 0)


def test_greedy_decode_through_llama_apply_matches_jax():
    """A tiny int8 model (W8A8 prefill, weight-only decode, int8 KV cache,
    two query heads a kv head): a left-padded prompt's prefill, then greedy
    steps, each feeding the argmax token's embedding back. The tokens equal
    the JAX package's, and the caches agree slot for slot."""
    kw = dict(act_quant=True, kv_quant=True, num_kv_heads=2)
    cfg_j = JLM.LlamaConfig.tiny(**kw)
    cfg_t = TLM.LlamaConfig.tiny(**kw)
    rng = np.random.RandomState(2)
    params = JLM.init_llama(jax.random.PRNGKey(1), cfg_j)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)
    params = jax.tree.map(np.asarray, j_quantize_llama(jax.tree.map(jnp.asarray, params)))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = TL.tree_map(tensor_from_numpy, params)
    table = np.asarray(params["embed_tokens"]["embedding"])

    b, s, new = 3, 7, 6
    total = s + new
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0
    cache_mask = np.concatenate([mask, np.ones((b, new), np.int32)], 1)
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    prompt = table[rng.randint(0, cfg_j.vocab_size, (b, s))]

    jcache = JLM.init_kv_cache(cfg_j, b, total)
    tcache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    jl, _, jcache = JLM.llama_apply(jparams, cfg_j, jnp.asarray(prompt), jnp.asarray(cache_mask),
                                    jnp.asarray(positions), kv_cache=jcache,
                                    cache_offset=jnp.int32(0))
    tl, _, tcache = TLM.llama_apply(tparams, cfg_t, torch.from_numpy(prompt),
                                    torch.from_numpy(cache_mask),
                                    torch.from_numpy(positions).long(), tcache, 0)
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
    ttok = tl[:, -1].argmax(-1).numpy()
    jtokens, ttokens = [jtok], [ttok]
    next_pos = mask.sum(1)
    for step in range(new - 1):
        pos = (next_pos + step)[:, None].astype(np.int32)
        jl, _, jcache = JLM.llama_apply(jparams, cfg_j, jnp.asarray(table[jtok][:, None]),
                                        jnp.asarray(cache_mask), jnp.asarray(pos),
                                        kv_cache=jcache, cache_offset=jnp.int32(s + step))
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
