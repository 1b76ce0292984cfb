"""Port parity: EVA ViT (certifiedgpt_tpu_torch/models/eva_vit.py) and the
shared layers against the JAX package, on the CPU, with the same seeded
parameters. The split-stream serving form is tested at 224 px (256
patches, so the split path is taken), with int8 kernels and W8A8
activations; there the JAX package runs its exact fallbacks off-TPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit as j_quantize_eva_vit
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy


def perturbed(tree, seed):
    """numpy copy of a JAX tree with every float leaf jittered, so that
    biases and norms are not at their zero/one init."""
    rng = np.random.RandomState(seed)

    def jitter(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return a
        return (a.astype(np.float32) + 0.05 * rng.randn(*a.shape)).astype(a.dtype)

    return jax.tree.map(jitter, tree)


def to_torch(tree):
    return TL.tree_map(tensor_from_numpy, tree)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    ln = {"scale": 1 + 0.1 * rng.randn(16).astype(np.float32),
          "bias": 0.1 * rng.randn(16).astype(np.float32)}
    jln = jax.tree.map(jnp.asarray, ln)
    tln = to_torch(ln)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(TL.layer_norm(tln, tx, 1e-5).numpy(),
                               np.asarray(JL.layer_norm(jln, jnp.asarray(x), 1e-5)), atol=1e-5)
    np.testing.assert_allclose(TL.rms_norm({"scale": tln["scale"]}, tx).numpy(),
                               np.asarray(JL.rms_norm({"scale": jln["scale"]}, jnp.asarray(x))),
                               atol=1e-5)
    np.testing.assert_allclose(TL.gelu(tx).numpy(), np.asarray(JL.gelu(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(TL.silu(tx).numpy(), np.asarray(JL.silu(jnp.asarray(x))), atol=1e-6)
    emb = {"embedding": rng.randn(11, 16).astype(np.float32)}
    ids = np.array([[1, 5, 10], [0, 0, 3]])
    np.testing.assert_array_equal(TL.embed(to_torch(emb), torch.from_numpy(ids)).numpy(),
                                  np.asarray(JL.embed(jax.tree.map(jnp.asarray, emb), ids)))
    jc, js = JL.rotary_tables(8, 32)
    tc, ts = TL.rotary_tables(8, 32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    xr = rng.randn(2, 3, 4, 8).astype(np.float32)
    pos = np.array([[0, 1, 2], [5, 6, 30]], np.int32)
    np.testing.assert_allclose(
        TL.apply_rotary(torch.from_numpy(xr), tc, ts, torch.from_numpy(pos).long()).numpy(),
        np.asarray(JL.apply_rotary(jnp.asarray(xr), jc, js, jnp.asarray(pos))), atol=1e-5)


def test_patchify_matches_jax():
    cfg_j = JV.EvaViTConfig.tiny()
    cfg_t = TV.EvaViTConfig.tiny()
    img = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    np.testing.assert_array_equal(TV.patchify(torch.from_numpy(img), cfg_t).numpy(),
                                  np.asarray(JV.patchify(jnp.asarray(img), cfg_j)))


FORMS = {  # form -> (EvaViTConfig overrides, int8 kernels with W8A8)
    "flash_cls_w8a8": (dict(img_size=224, attn_impl="flash_cls", act_quant=True), True),
    "flash_cls_float": (dict(img_size=224, attn_impl="flash_cls"), False),
    "xla_float": (dict(img_size=56, attn_impl="xla"), False),
    "flash_float": (dict(img_size=56, attn_impl="flash"), False),
    "flash_w8a8": (dict(img_size=56, attn_impl="flash", act_quant=True), True),
    "flash_custom_float": (dict(img_size=56, attn_impl="flash_custom"), False),
    "flash_custom_w8a8": (dict(img_size=56, attn_impl="flash_custom", act_quant=True), True),
    "flash_cls_4_patches": (dict(img_size=28, attn_impl="flash_cls"), False),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_eva_vit_matches_jax(form):
    """flash_cls_w8a8: the serving tower (split stream, int8 kernels, W8A8
    activations with the fused LN/GELU row quant); flash_cls_float: the
    same split stream with float kernels; xla_float: the plain block over
    the concatenated sequence; flash_*: the block with q, k, v as
    [B, H, S, dh] views of the fused qkv product into the flash kernel's
    plain version; flash_custom_*: the block with [B, S, H, dh] views into
    it; flash_cls_4_patches: flash_cls with a patch count that is not a
    multiple of 128, which takes the flash block. 16 and 4 patches give
    sequences of 17 and 5 tokens. Float forms agree to 1e-5 (f32 summation
    order). W8A8 to 5e-3: where the two f32 LayerNorms differ in the last
    ulp an int8 activation can round the other way, one quantization step
    (1/127 of its row's absmax), and attention spreads that to later tokens
    (measured 9e-4 here, 4e-7 with the same weights unquantized)."""
    kw, quantized = FORMS[form]
    cfg_j = JV.EvaViTConfig.tiny(**kw)
    cfg_t = TV.EvaViTConfig.tiny(**kw)
    params = JV.init_eva_vit(jax.random.PRNGKey(0), cfg_j)
    params = perturbed(params, 3)
    if quantized:
        params = jax.tree.map(np.asarray, j_quantize_eva_vit(jax.tree.map(jnp.asarray, params)))
    img = np.random.RandomState(2).randn(2, kw["img_size"], kw["img_size"], 3).astype(np.float32)
    want = np.asarray(JV.eva_vit_apply(jax.tree.map(jnp.asarray, params), cfg_j, jnp.asarray(img)))
    module = TV.EvaViT(cfg_t, to_torch(params))
    got = module(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, cfg_t.seq_len, cfg_t.embed_dim)
    assert rel_err(got, want) < (5e-3 if quantized else 1e-5)


@pytest.mark.parametrize("attn_impl", ["flash", "flash_cls"])
def test_eva_vit_rejects_unported_attention(attn_impl):
    """A string that names no attention form of the JAX package (a typo of
    ``attn_impl``) raises ValueError, as there, instead of falling back to
    another path."""
    typo = {"flash": "Flash", "flash_cls": "flash-cls"}[attn_impl]
    cfg = TV.EvaViTConfig.tiny(attn_impl=typo)
    params = to_torch(jax.tree.map(np.asarray, JV.init_eva_vit(
        jax.random.PRNGKey(0), JV.EvaViTConfig.tiny())))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        TV.eva_vit_apply(params, cfg, torch.zeros(1, 28, 28, 3))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        JV.eva_vit_apply(jax.tree.map(jnp.asarray, JV.init_eva_vit(
            jax.random.PRNGKey(0), JV.EvaViTConfig.tiny())), JV.EvaViTConfig.tiny(
                attn_impl=typo), jnp.zeros((1, 28, 28, 3)))
