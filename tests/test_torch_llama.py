"""Port parity: the decoder's cached mode (certifiedgpt_tpu_torch/models/
llama.py) against the JAX package on the CPU: a prefill of a left-padded
prompt then single-token decode steps over the KV cache, f32, with int8
kernels, W8A8 on the prefill and the int8 KV cache (the serving knobs),
and the plain float form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops.quantization import quantize_llama as j_quantize_llama
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("serving", [True, False], ids=["int8_kv8_w8a8", "float"])
def test_llama_cached_prefill_and_decode_match_jax(serving):
    """Float: 1e-5 relative (summation order). Serving knobs: 5e-3, the
    int8 activation and cache rounds can flip one step where the f32
    products differ in the last ulp."""
    kw = dict(act_quant=serving, kv_quant=serving, num_kv_heads=2)
    cfg_j = JLM.LlamaConfig.tiny(**kw)
    cfg_t = TLM.LlamaConfig.tiny(**kw)
    params = JLM.init_llama(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a)).astype(np.float32),
                          params)
    if serving:
        params = jax.tree.map(np.asarray, j_quantize_llama(jax.tree.map(jnp.asarray, params)))
    module = TLM.Llama(cfg_t, TL.tree_map(tensor_from_numpy, params))
    jparams = jax.tree.map(jnp.asarray, params)

    b, s, new = 3, 6, 3
    total = s + new
    mask = np.ones((b, s), np.int32)
    mask[1, :2] = 0  # left padding
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    cache_mask = np.concatenate([mask, np.ones((b, new), np.int32)], 1)
    x = rng.randn(b, s, cfg_j.hidden_size).astype(np.float32)

    jcache = JLM.init_kv_cache(cfg_j, b, total)
    tcache = TLM.init_kv_cache(cfg_t, b, total, "cpu")
    jl, jh, jcache = JLM.llama_apply(jparams, cfg_j, jnp.asarray(x), jnp.asarray(cache_mask),
                                     jnp.asarray(positions), kv_cache=jcache,
                                     cache_offset=jnp.int32(0))
    tl, th, tcache = module(torch.from_numpy(x), torch.from_numpy(cache_mask),
                            torch.from_numpy(positions).long(), tcache, 0)
    tol = 5e-3 if serving else 1e-5
    assert _rel(th.numpy(), np.asarray(jh)) < tol
    assert _rel(tl.numpy(), np.asarray(jl)) < tol

    next_pos = mask.sum(1)
    for t in range(new):
        tok = rng.randn(b, 1, cfg_j.hidden_size).astype(np.float32)
        pos = (next_pos + t)[:, None].astype(np.int32)
        jl, _, jcache = JLM.llama_apply(jparams, cfg_j, jnp.asarray(tok), jnp.asarray(cache_mask),
                                        jnp.asarray(pos), kv_cache=jcache,
                                        cache_offset=jnp.int32(s + t))
        tl, _, tcache = module(torch.from_numpy(tok), torch.from_numpy(cache_mask),
                               torch.from_numpy(pos).long(), tcache, s + t)
        assert tl.shape == (b, 1, cfg_t.vocab_size)
        assert _rel(tl.numpy(), np.asarray(jl)) < tol
    # the cache was written in place, slot for slot like the JAX cache
    for name in tcache:
        got = tcache[name][0].numpy()
        want = np.asarray(jcache[name][0])
        assert got.dtype == want.dtype
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            assert _rel(got, want) < tol


def test_lm_head_bias_and_embed():
    cfg = TLM.LlamaConfig.tiny()
    params = {"lm_head": {"kernel": torch.ones(cfg.hidden_size, 5),
                          "bias": torch.arange(5.0)},
              "embed_tokens": {"embedding": torch.arange(10.0)[:, None].expand(10, 4)}}
    logits = TLM.lm_head_logits(params, torch.ones(2, cfg.hidden_size))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), cfg.hidden_size + np.arange(5.0))
    assert TLM.embed_tokens(params, torch.tensor([[3, 7]]))[0, 1, 0] == 7.0
