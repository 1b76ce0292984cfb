"""Gradients of the decoder's fused elementwise ops (certifiedgpt_tpu_torch/
ops/elementwise.py: ``residual_norm``, ``rotate_qk``, ``swiglu``, the
autograd Functions of the training forward) on the CPU, where each runs the
plain versions of its forward and backward kernels.

Against autograd's gradient of the port's plain chains (the training
forward before these Functions: residual add, ``rms_norm_plain``,
``apply_rotary_plain``, ``silu(gate) * up``, one ``w8a8_matmul`` a product,
each quantizing its own input): bit for bit in bf16 and f32 (in f32, where
no rounding separates them, the plain backward adds the stream's later
gradient before the norm's two terms, as autograd does).

Against ``jax.vjp`` of the JAX chains, relative Frobenius error: 1e-5 in
f32 (XLA's reduction order and rsqrt); in bf16 2e-2 for the norm (a bf16
ulp is 2^-8: XLA rounds its f32 pieces elsewhere) and 3e-2 for SiLU x up
(the JAX ``silu`` is ``jax.nn.silu``, ``x * sigmoid(x)`` with a bf16
sigmoid, where the port takes the SiLU in f32); the rotary within 1e-5 in
f32 and 4e-3 in bf16. A tiny decoder block's input gradient (the JAX
``_block`` under ``jax.vjp``; W8A8 and float products, padded and packed
rows, each remat policy): within 1e-5 in f32 (7e-7 measured) and 3e-2 in
bf16 (the JAX bf16 SiLU and XLA's roundings; 1.3e-2 measured), bit for bit
the same block's without remat and, in bf16, the pre-Function chain's (in
f32 within 1e-6: before the first block's norm, autograd adds the stream's
two uses in its own order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy
from certifiedgpt_tpu_torch.ops import elementwise as E
from certifiedgpt_tpu_torch.ops import quantization as Q

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
EPS = 1e-6
JAX_NORM_REL = {"bf16": 2e-2, "f32": 1e-5}
JAX_SILU_REL = {"bf16": 3e-2, "f32": 1e-5}
JAX_ROTARY_REL = {"bf16": 4e-3, "f32": 1e-5}
JAX_BLOCK_REL = {"bf16": 3e-2, "f32": 1e-5}


def _pair(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _torch_grads(fn, inputs, cotangents):
    """``torch.autograd.grad`` of ``fn(*inputs)``'s outputs, weighted by
    ``cotangents``, in each input (fresh leaves)."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    return torch.autograd.grad(outs, leaves, cotangents, allow_unused=True)


def _jax_grads(fn, inputs, cotangents):
    """``jax.vjp`` of ``fn`` at ``inputs`` applied to ``cotangents``, jitted
    (one compilation, not one an op)."""
    return jax.jit(lambda i, c: jax.vjp(fn, *i)[1](c))(tuple(inputs), tuple(cotangents))


def _same(got, want) -> None:
    """Bit for bit."""
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def _int8_dense(rng, k: int, n: int):
    """An int8 dense leaf (per-channel scales) as torch and JAX arrays."""
    w = JQ.quantize_kernel(jnp.asarray(0.1 * rng.randn(k, n).astype(np.float32)))
    torch_leaf = {name: tensor_from_numpy(np.asarray(a)) for name, a in w.items()}
    return torch_leaf, w


@pytest.mark.parametrize("products", [0, 3], ids=["rows", "w8a8_qkv"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "first_layer"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_residual_norm_grad(dtype, residual, products):
    """``residual_norm``'s gradients in x, y and the scale: against the
    plain chain's (bit for bit) and
    ``jax.vjp`` of ``rms_norm(x + y)``. With ``products``, the norm's codes
    feed three W8A8 products (q/k/v), whose straight-through input
    gradients the backward sums as autograd sums three ``w8a8_matmul``s."""
    rng = np.random.RandomState(11 + residual + products)
    k, n = 64, 48
    x, xj = _pair((3.0 * rng.randn(2, 5, k)).astype(np.float32), dtype)
    y, yj = _pair(rng.randn(2, 5, k).astype(np.float32), dtype)
    scale, scale_j = _pair((1.0 + 0.1 * rng.randn(k)).astype(np.float32), dtype)
    dense = [_int8_dense(rng, k, n) for _ in range(products)]
    width = n if products else k
    cots = [rng.randn(2, 5, width).astype(np.float32) for _ in range(max(products, 1))]
    if residual:  # the stream's gradient from its later uses
        cots = [rng.randn(2, 5, k).astype(np.float32)] + cots
    t_cots = [_pair(c, dtype)[0] for c in cots]
    j_cots = [_pair(c, dtype)[1] for c in cots]

    def fused(x, y, scale):
        s, out = E.residual_norm(x, y if residual else None, scale, EPS,
                                 dense=[d[0] for d in dense] or None)
        return ([s] if residual else []) + (out if products else [out])

    def chain(x, y, scale):
        s = x + y if residual else x
        h = E.rms_norm_plain(s, scale, EPS)
        outs = [Q.w8a8_matmul(h, d[0]["kernel_q"], d[0]["scale"]) for d in dense] or [h]
        return ([s] if residual else []) + outs

    def jax_chain(x, y, scale):
        s = x + y if residual else x
        h = JL.rms_norm({"scale": scale}, s, EPS)
        outs = [JQ.w8a8_matmul(h, d[1]["kernel_q"], d[1]["scale"]) for d in dense] or [h]
        return tuple(([s] if residual else []) + outs)

    got = _torch_grads(fused, (x, y, scale), t_cots)
    want = _torch_grads(chain, (x, y, scale), t_cots)
    jwant = _jax_grads(jax_chain, (xj, yj, scale_j), j_cots)
    for i, name in enumerate(("x", "y", "scale")):
        if name == "y" and not residual:
            assert got[i] is None or not got[i].any()
            continue
        _same(got[i], want[i])
        assert _rel(got[i], jwant[i]) < JAX_NORM_REL[dtype], (name, _rel(got[i], jwant[i]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rotate_qk_grad(dtype):
    """``rotate_qk``'s gradients in q (4 heads) and k (2 kv heads) at
    restarting (packed) positions: bit for bit the plain chain's, within
    ``JAX_ROTARY_REL`` of ``jax.vjp`` of ``apply_rotary`` on the same
    tables; the forward returns new tensors and leaves q and k alone."""
    rng = np.random.RandomState(5)
    b, s, dh, max_len = 2, 7, 16, 64
    positions = np.array([[0, 1, 2, 0, 1, 2, 3], [5, 6, 7, 8, 9, 10, 11]], np.int32)
    q, qj = _pair(rng.randn(b, s, 4, dh).astype(np.float32), dtype)
    k, kj = _pair(rng.randn(b, s, 2, dh).astype(np.float32), dtype)
    gq, gqj = _pair(rng.randn(b, s, 4, dh).astype(np.float32), dtype)
    gk, gkj = _pair(rng.randn(b, s, 2, dh).astype(np.float32), dtype)
    cos, sin = E.rotary_tables(dh, max_len)
    pos = torch.from_numpy(positions).long()
    q0 = q.clone()
    got = _torch_grads(lambda q, k: E.rotate_qk(q, k, cos, sin, pos), (q, k), (gq, gk))
    assert torch.equal(q, q0)
    want = _torch_grads(lambda q, k: E._rotary_plain(q, k, cos, sin, pos), (q, k), (gq, gk))
    cos_j, sin_j, pj = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), jnp.asarray(positions)
    jwant = _jax_grads(lambda q, k: (JL.apply_rotary(q, cos_j, sin_j, pj),
                                     JL.apply_rotary(k, cos_j, sin_j, pj)), (qj, kj), (gqj, gkj))
    for g, w, jw in zip(got, want, jwant):
        _same(g, w)
        assert _rel(g, jw) < JAX_ROTARY_REL[dtype], _rel(g, jw)


@pytest.mark.parametrize("down", [False, True], ids=["rows", "w8a8_down"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_swiglu_grad(dtype, down):
    """``swiglu``'s gradients in gate and up (with ``down``, through the
    down_proj's W8A8 product on its codes): bit for bit the plain chain's,
    within ``JAX_SILU_REL`` of ``jax.vjp`` of ``silu(gate) * up``."""
    rng = np.random.RandomState(7 + down)
    m, n, k = 6, 96, 32
    gate, gate_j = _pair((3.0 * rng.randn(m, n)).astype(np.float32), dtype)
    up, up_j = _pair(rng.randn(m, n).astype(np.float32), dtype)
    leaf, jleaf = _int8_dense(rng, n, k) if down else (None, None)
    g, gj = _pair(rng.randn(m, k if down else n).astype(np.float32), dtype)

    def chain(gate, up):
        a = E._silu_mul_plain(gate, up)
        return Q.w8a8_matmul(a, leaf["kernel_q"], leaf["scale"]) if down else a

    def jax_chain(gate, up):
        a = JL.silu(gate) * up
        return JQ.w8a8_matmul(a, jleaf["kernel_q"], jleaf["scale"]) if down else a

    got = _torch_grads(lambda gate, up: E.swiglu(gate, up, dense=leaf), (gate, up), (g,))
    want = _torch_grads(chain, (gate, up), (g,))
    jwant = _jax_grads(lambda gate, up: (jax_chain(gate, up),), (gate_j, up_j), (gj,))
    for got_i, want_i, jwant_i in zip(got, want, jwant):
        _same(got_i, want_i)
        assert _rel(got_i, jwant_i) < JAX_SILU_REL[dtype], _rel(got_i, jwant_i)


def _chain_block(x, lp, cfg, cos, sin, positions, mask):
    """The training block before the fused ops' Functions: the plain chain,
    each residual added where it is made, each product quantizing its own
    input."""
    b, s, _ = x.shape
    aq = cfg.act_quant and s > 1

    def dense(name, h):
        return TL.dense(lp[name], h, act_quant=aq)

    hidden = TL.rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    q, k, v = (dense(n, hidden).reshape(b, s, -1, cfg.head_dim)
               for n in ("q_proj", "k_proj", "v_proj"))
    q = TL.apply_rotary(q, cos, sin, positions)
    k = TL.apply_rotary(k, cos, sin, positions)
    x = x + dense("o_proj", TLM._attend(q, k, v, cfg, mask, None, None).reshape(b, s, -1))
    hidden = TL.rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    return x + dense("down_proj", TL.silu(dense("gate_proj", hidden)) * dense("up_proj", hidden))


def _block_inputs(packed: bool):
    b, s = 2, 8
    mask = np.ones((b, s), np.int32)
    mask[1, 6:] = 0
    if not packed:
        return mask, np.tile(np.arange(s, dtype=np.int32), (b, 1)), None
    seg = np.array([[1, 1, 1, 2, 2, 2, 2, 2], [1, 1, 1, 1, 2, 2, 0, 0]], np.int32)
    pos = np.array([[0, 1, 2, 0, 1, 2, 3, 4], [0, 1, 2, 3, 0, 1, 0, 0]], np.int32)
    return mask, pos, seg


@functools.lru_cache(maxsize=None)
def _block_case(dtype: str, quant: bool, packed: bool):
    """A tiny W8A8 (or float) layer, inputs, a cotangent and ``jax.vjp`` of
    the JAX ``_block`` in the input."""
    tdt, jdt = DTYPES[dtype]
    kw = dict(num_layers=1, act_quant=quant, num_kv_heads=2)
    cfg_j = JLM.LlamaConfig.tiny(dtype=jdt, **kw)
    cfg_t = TLM.LlamaConfig.tiny(dtype=tdt, **kw)
    rng = np.random.RandomState(21)
    d, inter, kv = cfg_j.hidden_size, cfg_j.intermediate_size, 2 * cfg_j.head_dim
    shapes = {"q_proj": (d, d), "k_proj": (d, kv), "v_proj": (d, kv), "o_proj": (d, d),
              "gate_proj": (d, inter), "up_proj": (d, inter), "down_proj": (inter, d)}
    layer = {name: {"scale": (1.0 + 0.1 * rng.randn(d)).astype(np.float32)}
             for name in ("input_layernorm", "post_attention_layernorm")}
    for name, shape in shapes.items():
        w = (0.2 * rng.randn(*shape)).astype(np.float32)
        layer[name] = ({k: np.asarray(a) for k, a in JQ.quantize_kernel(jnp.asarray(w)).items()}
                       if quant else {"kernel": w})
    mask, pos, seg = _block_inputs(packed)
    x = rng.randn(2, 8, cfg_j.hidden_size).astype(np.float32)
    r = rng.randn(2, 8, cfg_j.hidden_size).astype(np.float32)
    s = x.shape[1]
    jmask = jnp.tril(jnp.ones((s, s), jnp.bool_))[None, None] & jnp.asarray(mask)[:, None, None,
                                                                                   :].astype(bool)
    if seg is not None:
        jmask = jmask & (jnp.asarray(seg)[:, :, None] == jnp.asarray(seg)[:, None, :])[:, None]
    cos, sin = JL.rotary_tables(cfg_j.head_dim, cfg_j.max_position_embeddings, cfg_j.rope_theta)
    jlayer = jax.tree.map(jnp.asarray, layer)

    (jgrad,) = _jax_grads(
        lambda xx: (JLM._block(xx, jlayer, cfg_j, cos, sin, jnp.asarray(pos), jmask, None,
                               None)[0],),
        (jnp.asarray(x).astype(jdt),), (jnp.asarray(r).astype(jdt),))
    return cfg_t, TL.tree_map(tensor_from_numpy, layer), x, r, mask, pos, seg, jgrad


@pytest.mark.parametrize("remat", ["none", "full", "dots", "dots_all"])
@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("quant", [True, False], ids=["w8a8", "float"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_block_input_grad_matches_jax(dtype, quant, packed, remat):
    """A tiny decoder block's input gradient through the fused ops (one
    layer of ``_run_layers``, the final residual add after it) under each
    remat policy: within ``JAX_BLOCK_REL`` of ``jax.vjp`` of the JAX
    ``_block``, bit for bit the block without remat and, in bf16, the
    pre-Function chain's (f32: within 1e-6 relative)."""
    cfg, lp, x, r, mask, pos, seg, jgrad = _block_case(dtype, quant, packed)
    tdt = DTYPES[dtype][0]
    cfg = dataclasses.replace(cfg, remat=remat != "none",
                              remat_policy="full" if remat == "none" else remat)
    params = {"layers": TL.tree_map(lambda a: a[None], lp)}
    cos, sin = E.rotary_tables(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta)
    tpos = torch.from_numpy(pos).long()
    tmask = TLM.TrainingMask(torch.from_numpy(mask), None if seg is None
                             else torch.from_numpy(seg))
    xt, rt = torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt)

    def run(cfg):
        def fwd(xx):
            out, y = TLM._run_layers(params, cfg, xx, cos, sin, tpos, tmask)
            return out + y
        return _torch_grads(fwd, (xt,), (rt,))[0]

    got = run(cfg)
    assert _rel(got, jgrad) < JAX_BLOCK_REL[dtype], _rel(got, jgrad)
    if remat != "none":
        assert torch.equal(got, run(dataclasses.replace(cfg, remat=False)))
    want = _torch_grads(lambda xx: _chain_block(xx, lp, cfg, cos, sin, tpos, tmask), (xt,),
                        (rt,))[0]
    if dtype == "bf16":
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) < 1e-6, _rel(got, want)
