"""Port parity of the attack modules (``attack/clip.py``, ``attack/attack.py``)
on the CPU: the same seeded numpy inputs and JAX-initialized weights
(carried across by ``surrogate_params_from_jax``) go through the JAX
function and its port.

Tolerances (f32 throughout): embeddings atol 1e-5 and rtol 1e-5 against
the JAX package; against HF ``CLIPModel`` the JAX test's 2e-4 / 1e-3; the
resize within 1e-5 at 448->224 and 28->32 and 5e-5 at 300->224 (value and
VJP); one PGD step's gradient within 1e-6 absolute (1e-4 of its largest
entry); after a few steps at least 99 % of the pixels equal JAX's (a sign
step turns a 1e-7 difference of a near-zero gradient entry into a whole
step); the numpy stages (RGF, success, ANCOVA) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.attack import attack as JA
from certifiedgpt_tpu.attack import clip as JC
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu_torch.attack import attack as TA
from certifiedgpt_tpu_torch.attack import clip as TC
from certifiedgpt_tpu_torch.attack.agent import eva_feature
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models.from_jax import surrogate_params_from_jax

from chip_smoke import openai_resnet_shapes

ATOL = RTOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _randomize_bn(tree, rng):
    """Running statistics away from 0/1, so that a folding fault cannot hide."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["mean"].shape
            return {"scale": 1.0 + 0.1 * rng.randn(*c).astype(np.float32),
                    "bias": 0.1 * rng.randn(*c).astype(np.float32),
                    "mean": 0.1 * rng.randn(*c).astype(np.float32),
                    "var": (0.5 + rng.rand(*c)).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def _jax_eva_feature(params, cfg, images):
    return JV.eva_vit_apply(params, cfg, images)[:, 0]


@pytest.fixture(scope="module")
def surrogates():
    """Tiny ViT, ResNet (random BN statistics) and EVA surrogates: JAX
    configs, JAX trees (numpy) and the port's configs and trees."""
    rng = np.random.RandomState(0)
    jv, tv = JC.ClipViTConfig.tiny(), TC.ClipViTConfig.tiny()
    jr, tr = JC.ClipResNetConfig.tiny(), TC.ClipResNetConfig.tiny()
    je, te = JV.EvaViTConfig.tiny(), TV.EvaViTConfig.tiny()
    vit = _np_tree(jax.jit(JC.init_clip_vit, static_argnums=1)(jax.random.PRNGKey(0), jv))
    rn = _randomize_bn(_np_tree(jax.jit(JC.init_clip_resnet, static_argnums=1)(
        jax.random.PRNGKey(1), jr)), rng)
    eva = _np_tree(jax.jit(JV.init_eva_vit, static_argnums=1)(jax.random.PRNGKey(2), je))
    return {
        "vit": (jv, JC.clip_vit_image, vit, tv, TC.clip_vit_image),
        "rn": (jr, JC.clip_resnet_image, rn, tr, TC.clip_resnet_image),
        "eva": (je, _jax_eva_feature, eva, te, eva_feature),
    }


@pytest.mark.parametrize("name", ["vit", "rn", "eva"])
def test_image_towers_match_jax(surrogates, name):
    jcfg, jfn, tree, tcfg, tfn = surrogates[name]
    size = getattr(jcfg, "image_size", None) or jcfg.img_size
    imgs = np.random.RandomState(3).randn(2, size, size, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jfn, static_argnums=1)(tree, jcfg, jnp.asarray(imgs)))
    got = tfn(surrogate_params_from_jax(tree, "cpu"), tcfg, _t(imgs)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_clip_text_matches_jax():
    jcfg, tcfg = JC.ClipTextConfig.tiny(), TC.ClipTextConfig.tiny()
    tree = _np_tree(jax.jit(JC.init_clip_text, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    params = surrogate_params_from_jax(tree, "cpu")
    assert isinstance(params["layers"], list) and len(params["layers"]) == jcfg.num_layers
    ids = np.asarray([[5, 9, 99, 0, 0], [7, 99, 0, 0, 0], [3, 4, 5, 6, 99]])  # 99 = EOT
    ref = np.asarray(jax.jit(JC.clip_text, static_argnums=1)(tree, jcfg, jnp.asarray(ids)))
    got = TC.clip_text(params, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_seeded_inits_have_the_jax_trees_shapes():
    """The port's seeded inits build the JAX package's tree (keys, list
    lengths, shapes), so a JAX or converted tree can stand in for them."""
    from certifiedgpt_tpu_torch.attack.agent import AttackAgent

    for jcfg, jinit, tcfg, tinit in (
        (JC.ClipViTConfig.tiny(), JC.init_clip_vit, TC.ClipViTConfig.tiny(), TC.init_clip_vit),
        (JC.ClipTextConfig.tiny(), JC.init_clip_text, TC.ClipTextConfig.tiny(),
         TC.init_clip_text),
        (JC.ClipResNetConfig.tiny(layers=(2, 1, 2, 1)), JC.init_clip_resnet,
         TC.ClipResNetConfig.tiny(layers=(2, 1, 2, 1)), TC.init_clip_resnet),
    ):
        shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
        ref = surrogate_params_from_jax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), "cpu")
        got = tinit(7, tcfg, "cpu")
        assert AttackAgent._shapes_match(ref, got)
        again = tinit(7, tcfg, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got),
                                                       jax.tree.leaves(again)))
    # std 1/sqrt(fan-in), truncated at 2 std
    kernel = TC.init_clip_vit(0, TC.ClipViTConfig.tiny(), "cpu")["layers"][0]["fc1"]["kernel"]
    assert float(kernel.abs().max()) <= 2 * 32 ** -0.5
    assert abs(float(kernel.std()) - 0.88 * 32 ** -0.5) < 0.02


def _tiny_hf_clip():
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    v = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, image_size=28, patch_size=14,
                         projection_dim=16, hidden_act="quick_gelu")
    t = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=16, vocab_size=100,
                       projection_dim=16, hidden_act="quick_gelu",
                       bos_token_id=98, eos_token_id=99)
    torch.manual_seed(0)
    return CLIPModel(CLIPConfig(text_config=t.to_dict(), vision_config=v.to_dict(),
                                projection_dim=16)).eval()


def test_convert_hf_clip_matches_jax_and_hf():
    hf = _tiny_hf_clip()
    sd = hf.state_dict()
    jcv, jct = JC.ClipViTConfig.tiny(), JC.ClipTextConfig.tiny()
    tcv, tct = TC.ClipViTConfig.tiny(), TC.ClipTextConfig.tiny()
    ref = _np_tree(JC.convert_hf_clip(sd, jcv, jct))
    got = TC.convert_hf_clip(sd, tcv, tct)
    ref_leaves, ref_def = jax.tree.flatten(ref)
    got_leaves, got_def = jax.tree.flatten(got)
    assert ref_def == got_def
    for a, b in zip(ref_leaves, got_leaves):
        assert b.dtype == torch.float32 and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), a)

    rng = np.random.RandomState(1)
    imgs = rng.randn(2, 28, 28, 3).astype(np.float32)
    with torch.no_grad():
        ref_v = hf.get_image_features(pixel_values=_t(imgs).permute(0, 3, 1, 2))
        ours_v = TC.clip_vit_image(got["vision"], tcv, _t(imgs))
    np.testing.assert_allclose(ours_v.numpy(), torch.as_tensor(ref_v).numpy(),
                               atol=2e-4, rtol=1e-3)
    ids = rng.randint(1, 99, (2, 8))
    ids[:, -1] = 99  # EOT = max id; HF pools at argmax(ids) too
    with torch.no_grad():
        ref_t = hf.get_text_features(input_ids=torch.tensor(ids))
        ours_t = TC.clip_text(got["text"], tct, torch.tensor(ids))
    np.testing.assert_allclose(ours_t.numpy(), torch.as_tensor(ref_t).numpy(),
                               atol=2e-4, rtol=1e-3)


def openai_resnet_state_dict(cfg, rng):
    """An OpenAI ``visual.*`` ResNet state dict at ``cfg``'s widths (the keys
    of ``chip_smoke.openai_resnet_shapes``) with random weights and BN
    statistics."""
    sd = {}
    for key, shape in openai_resnet_shapes(cfg):
        if shape is None:
            sd[key] = torch.tensor(0)
            continue
        t = rng.randn(*shape).astype(np.float32)
        if key.endswith("running_var"):
            t = 0.5 + np.abs(t)
        elif key.endswith("weight") and len(shape) == 1:
            t = 1.0 + 0.1 * t
        elif len(shape) >= 2 and "positional" not in key:
            t = t * np.prod(shape[1:]) ** -0.5
        else:
            t = 0.1 * t
        sd[key] = torch.from_numpy(t.astype(np.float32))
    return sd


def test_convert_openai_clip_resnet_matches_jax():
    jcfg, tcfg = JC.ClipResNetConfig.tiny(layers=(2, 1, 1, 1)), TC.ClipResNetConfig.tiny(
        layers=(2, 1, 1, 1))
    sd = openai_resnet_state_dict(tcfg, np.random.RandomState(0))
    ref = _np_tree(JC.convert_openai_clip_resnet(sd, jcfg))
    got = TC.convert_openai_clip_resnet(sd, tcfg)
    ref_leaves, ref_def = jax.tree.flatten(ref)
    got_leaves, got_def = jax.tree.flatten(got)
    assert ref_def == got_def
    for a, b in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(b.numpy(), a)
    imgs = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    jfn = jax.jit(JC.clip_resnet_image, static_argnums=1)
    np.testing.assert_allclose(TC.clip_resnet_image(got, tcfg, _t(imgs)).numpy(),
                               np.asarray(jfn(ref, jcfg, jnp.asarray(imgs))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("src,dst,tol", [(448, 224, 1e-5), (300, 224, 5e-5), (28, 32, 1e-5)])
def test_resize_value_and_vjp_match_jax(src, dst, tol):
    """``_resize`` is ``jax.image.resize(..., "bilinear")``: anti-aliased
    when it downsamples (without it the 448->224 image differs by ~0.3),
    and its VJP, which the PGD differentiates through, agrees too."""
    rng = np.random.RandomState(src)
    x = rng.rand(2, src, src, 3).astype(np.float32)
    cot = rng.randn(2, dst, dst, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: JA._resize(a, dst), jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(cot))
    xt = _t(x).requires_grad_(True)
    got = TA._resize(xt, dst)
    (got_grad,) = torch.autograd.grad(got, xt, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=0)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(ref_grad), atol=tol, rtol=0)
    assert TA._resize(xt, src) is xt


def _ensembles(surrogates, names):
    """(JAX encoders, port encoders, JAX params, port params) for ``names``."""
    jencs, tencs, jp, tp = [], [], {}, {}
    for name in names:
        jcfg, jfn, tree, tcfg, tfn = surrogates[name]
        size = getattr(jcfg, "image_size", None) or jcfg.img_size
        jencs.append(JA.SurrogateEncoder(name, lambda p, x, f=jfn, c=jcfg: f(p, c, x),
                                         tree, size))
        tencs.append(TA.SurrogateEncoder(name, lambda p, x, f=tfn, c=tcfg: f(p, c, x),
                                         surrogate_params_from_jax(tree, "cpu"), size))
        jp[name] = tree
        tp[name] = tencs[-1].params
    return jencs, tencs, jp, tp


def _jax_loss(encoders):
    """The loss of the JAX package's ``make_pgd_attack`` (a closure there)."""
    def loss(x, params_by_name, targets):
        total = 0.0
        for enc in encoders:
            feats = enc.apply_fn(params_by_name[enc.name],
                                 JA._normalize(JA._resize(x, enc.image_size)))
            total = total + jnp.mean(1.0 - JA.cosine_similarity(feats, targets[enc.name]))
        return total / len(encoders)

    return loss


@pytest.mark.parametrize("names", [("vit",), ("rn",), ("vit", "rn", "eva")])
def test_pgd_gradient_matches_jax_grad(surrogates, names):
    """One PGD step's gradient: 56 px pixels resized down to each
    surrogate's 28 or 32 px."""
    jencs, tencs, jp, tp = _ensembles(surrogates, names)
    rng = np.random.RandomState(5)
    x = rng.rand(2, 56, 56, 3).astype(np.float32)
    targets = {n: rng.randn(2, 16 if n == "vit" else 32).astype(np.float32) for n in names}
    ref = np.asarray(jax.jit(jax.grad(_jax_loss(jencs)))(jnp.asarray(x), jp,
                                                {k: jnp.asarray(v) for k, v in targets.items()}))
    xt = _t(x).requires_grad_(True)
    loss = TA.ensemble_loss(tencs, xt, tp, {k: _t(v) for k, v in targets.items()})
    (got,) = torch.autograd.grad(loss, xt)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=max(1e-6, 1e-4 * scale), rtol=0)
    assert all(not leaf.requires_grad for leaf in jax.tree.leaves(tp))


def test_pgd_steps_agree_with_jax(surrogates):
    names = ("vit", "rn")
    jencs, tencs, jp, tp = _ensembles(surrogates, names)
    rng = np.random.RandomState(6)
    x = rng.rand(1, 56, 56, 3).astype(np.float32)
    target_px = rng.rand(1, 56, 56, 3).astype(np.float32)
    eps, step, steps = 8 / 255, 1 / 255, 5
    jt = jax.jit(lambda p, x: JA.embed_images(jencs, p, x))(jp, jnp.asarray(target_px))
    tt = TA.embed_images(tencs, tp, _t(target_px))
    for n in names:
        np.testing.assert_allclose(tt[n].numpy(), np.asarray(jt[n]), atol=ATOL, rtol=RTOL)
        assert not tt[n].requires_grad
    ref = np.asarray(JA.make_pgd_attack(jencs, eps, step, steps)(jp, jnp.asarray(x), jt))
    with torch.no_grad():  # the attack turns autograd on for itself
        got = TA.make_pgd_attack(tencs, eps, step, steps)(tp, _t(x), tt).numpy()
    assert np.mean(got == ref) >= 0.99
    assert np.abs(got - x).max() <= eps + 1e-6
    assert got.min() >= 0.0 and got.max() <= 1.0
    # the steps moved the embeddings toward the target
    before = TA.ensemble_loss(tencs, _t(x), tp, tt)
    after = TA.ensemble_loss(tencs, torch.from_numpy(got), tp, tt)
    assert float(after) < float(before)


def test_exact_f32_restores_the_callers_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with TA.exact_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_rgf_success_and_ancova_equal_jax():
    rng = np.random.RandomState(0)
    x0 = rng.rand(4, 4, 3).astype(np.float32) * 0.5 + 0.25
    direction = rng.randn(4, 4, 3).astype(np.float32)
    direction /= np.linalg.norm(direction)

    def score(x):
        return float(np.sum(x * direction))

    kw = dict(epsilon=0.1, sigma=0.05, step_size=0.02, queries=16, iters=8, seed=(1, 2, 3))
    got = TA.rgf_refine(score, x0.copy(), x0, **kw)
    np.testing.assert_array_equal(got, JA.rgf_refine(score, x0.copy(), x0, **kw))
    assert score(got) > score(x0)

    for clean, adv in ((0.2, 0.5), (0.5, 0.2), (0.3, 0.3)):
        assert TA.attack_success(clean, adv) == JA.attack_success(clean, adv)
        assert TA.attack_success(clean, adv, 0.1) == JA.attack_success(clean, adv, 0.1)

    gen = np.random.default_rng(0)
    rows = [{"similarity": 0.5 + slope * sigma + 0.001 * gen.standard_normal(),
             "sigma": sigma, "backbone": backbone}
            for backbone, slope in (("rn50", -0.01), ("vit", -0.02), ("blip", 0.0))
            for sigma in (0.0, 0.25, 0.5, 1.0) for _ in range(5)]
    for interaction in (True, False):
        assert TA.ancova(rows, interaction=interaction) == JA.ancova(rows,
                                                                    interaction=interaction)


def test_surrogate_params_from_jax_keeps_lists_and_mappings():
    tree = {"layers": [{"a": np.ones((2, 3), np.float32)}, {"a": np.zeros(2, np.float32)}],
            "b": np.arange(3, dtype=np.float32)}
    out = surrogate_params_from_jax(tree, "cpu")
    assert isinstance(out["layers"], list) and out["layers"][0]["a"].shape == (2, 3)
    assert torch.equal(out["b"], torch.arange(3, dtype=torch.float32))
    # a tuple of blocks comes across as a list, as the port's trees hold them
    assert isinstance(surrogate_params_from_jax((tree["b"],), "cpu"), list)


def test_tiny_configs_match_jax():
    for jcfg, tcfg in ((JC.ClipViTConfig.tiny(), TC.ClipViTConfig.tiny()),
                       (JC.ClipViTConfig.l14(), TC.ClipViTConfig.l14()),
                       (JC.ClipTextConfig(), TC.ClipTextConfig()),
                       (JC.ClipResNetConfig.rn101(), TC.ClipResNetConfig.rn101())):
        ref = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
        assert ref == {k: v for k, v in dataclasses.asdict(tcfg).items() if k != "dtype"}
        assert tcfg.dtype == torch.float32
