"""Port parity of the training forward, on the CPU: the decoder without a
cache (padding, packed segments, every remat policy and ``remat_every``)
against the JAX package's ``llama_apply`` in logits and input gradients,
remat on and off giving the same numbers; ``minigpt4_loss`` packed and
unpacked, with its ``llama_proj`` gradient, against ``jax.grad`` of the JAX
loss (float towers, and the W8A8 towers of the shipped ``_w8a8`` training
config); a packed row that is all padding gives a finite loss and finite
gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from certifiedgpt_tpu.data import text as JT
from certifiedgpt_tpu.models import eva_vit as JV
from certifiedgpt_tpu.models import llama as JLM
from certifiedgpt_tpu.models import minigpt4 as JM
from certifiedgpt_tpu.ops.quantization import quantize_eva_vit, quantize_llama
from certifiedgpt_tpu_torch.models import eva_vit as TV
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.from_jax import params_from_jax, tensor_from_numpy
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _decoder(act_quant):
    cfg_j = JLM.LlamaConfig.tiny(num_layers=4, act_quant=act_quant)
    params = JLM.init_llama(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)
    if act_quant:
        params = jax.tree.map(np.asarray, quantize_llama(jax.tree.map(jnp.asarray, params)))
    return cfg_j, params


def _decoder_inputs(packed: bool):
    """Two rows of 12 slots: right padding, and with ``packed`` three
    segments in the first row (restarting positions) and two in the
    second, whose tail slots are pad (segment id 0)."""
    b, s = 2, 12
    rng = np.random.RandomState(2)
    x = rng.randn(b, s, 64).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0
    if not packed:
        return x, mask, np.tile(np.arange(s, dtype=np.int32), (b, 1)), None
    seg = np.array([[1] * 4 + [2] * 5 + [3] * 3, [1] * 6 + [2] * 3 + [0] * 3], np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        for sid in set(seg[r].tolist()) - {0}:
            idx = np.where(seg[r] == sid)[0]
            pos[r, idx] = np.arange(len(idx))
    return x, mask, pos, seg


REMAT = [(False, "full", 1), (True, "full", 1), (True, "dots", 1), (True, "dots_all", 1),
         (True, "full", 2)]


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("remat,policy,every", REMAT,
                         ids=["no_remat", "full", "dots", "dots_all", "full_every2"])
def test_training_forward_matches_jax(packed, remat, policy, every):
    """Logits and ``d sum(logits * r) / d inputs_embeds`` within 1e-5
    relative of the JAX package's no-cache ``llama_apply`` (f32, summation
    order); under remat the port's numbers equal its own without remat,
    bit for bit."""
    cfg_j, params = _decoder(False)
    knobs = dict(num_layers=4, remat=remat, remat_policy=policy, remat_every=every)
    cfg_t = TLM.LlamaConfig.tiny(**knobs)
    tparams = TL.tree_map(tensor_from_numpy, params)
    x, mask, pos, seg = _decoder_inputs(packed)
    r = np.random.RandomState(3).randn(2, 12, cfg_j.vocab_size).astype(np.float32)

    def jloss(emb):
        logits, _, _ = JLM.llama_apply(jax.tree.map(jnp.asarray, params), cfg_j, emb,
                                       jnp.asarray(mask), jnp.asarray(pos),
                                       segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(logits * r), logits

    (_, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    def run(cfg):
        emb = torch.tensor(x, requires_grad=True)
        logits, _, cache = TLM.llama_apply(
            tparams, cfg, emb, torch.from_numpy(mask), torch.from_numpy(pos).long(),
            segment_ids=None if seg is None else torch.from_numpy(seg))
        (logits * torch.from_numpy(r)).sum().backward()
        assert cache is None
        return logits.detach(), emb.grad

    logits, grad = run(cfg_t)
    assert _rel(logits.numpy(), np.asarray(jlogits)) < 1e-5
    assert _rel(grad.numpy(), np.asarray(jgrad)) < 1e-5
    if remat:
        plain_logits, plain_grad = run(dataclasses.replace(cfg_t, remat=False))
        assert torch.equal(logits, plain_logits) and torch.equal(grad, plain_grad)


class _CountProducts(TorchDispatchMode):
    """Counts the products that run below it (a product that selective
    checkpointing returns from its cache never reaches it)."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_do_not_save():
    """The products a backward runs (4 layers: 7 projections and 2
    attention products a layer, plus the head): without remat, the
    gradients' only; ``full`` also recomputes the products; ``dots``
    reuses the projections' saved outputs and recomputes the attention's;
    ``dots_all`` reuses them all."""
    cfg_j, params = _decoder(False)
    tparams = TL.tree_map(tensor_from_numpy, params)
    x, mask, pos, _ = _decoder_inputs(False)
    counts = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots"), (True, "dots_all")):
        cfg = TLM.LlamaConfig.tiny(num_layers=4, remat=remat, remat_policy=policy)
        emb = torch.tensor(x, requires_grad=True)
        logits, _, _ = TLM.llama_apply(tparams, cfg, emb, torch.from_numpy(mask),
                                       torch.from_numpy(pos).long())
        with _CountProducts() as mode:
            logits.sum().backward()
        counts[policy if remat else "none"] = mode.counts
    grads = {"mm": 4 * 7 + 1, "bmm": 4 * 4}
    assert counts["none"] == grads
    # the recompute stops once the saved tensors the backward needs are
    # back: the last projection of a block (down_proj) is not rerun
    assert counts["full"] == {"mm": grads["mm"] + 4 * 6, "bmm": grads["bmm"] + 4 * 2}
    assert counts["dots"] == {"mm": grads["mm"], "bmm": grads["bmm"] + 4 * 2}
    assert counts["dots_all"] == grads


def test_remat_refuses_bad_knobs():
    cfg_j, params = _decoder(False)
    tparams = TL.tree_map(tensor_from_numpy, params)
    x, mask, pos, _ = _decoder_inputs(False)
    args = (tparams, None, torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(pos).long())
    with pytest.raises(ValueError, match="remat_every=3"):
        TLM.llama_apply(args[0], TLM.LlamaConfig.tiny(num_layers=4, remat=True, remat_every=3),
                        *args[2:])
    with pytest.raises(ValueError, match="remat_policy"):
        TLM.llama_apply(args[0], TLM.LlamaConfig.tiny(num_layers=4, remat=True,
                                                      remat_policy="offload"), *args[2:])


def test_w8a8_training_forward_matches_jax():
    """The shipped ``_w8a8`` training config's decoder: int8 kernels, W8A8
    activations on the 12-token rows, straight-through backward. Logits
    and input gradients within 5e-3 relative (an activation code may flip
    one step where the f32 products differ in the last ulp)."""
    cfg_j, params = _decoder(True)
    cfg_t = TLM.LlamaConfig.tiny(num_layers=4, act_quant=True)
    tparams = TL.tree_map(tensor_from_numpy, params)
    x, mask, pos, seg = _decoder_inputs(True)

    def jloss(emb):
        logits, _, _ = JLM.llama_apply(jax.tree.map(jnp.asarray, params), cfg_j, emb,
                                       jnp.asarray(mask), jnp.asarray(pos),
                                       segment_ids=jnp.asarray(seg))
        return jnp.sum(logits ** 2) / 1e3, logits

    (_, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    emb = torch.tensor(x, requires_grad=True)
    logits, _, _ = TLM.llama_apply(tparams, cfg_t, emb, torch.from_numpy(mask),
                                   torch.from_numpy(pos).long(),
                                   segment_ids=torch.from_numpy(seg))
    ((logits ** 2).sum() / 1e3).backward()
    assert _rel(logits.detach().numpy(), np.asarray(jlogits)) < 5e-3
    assert _rel(emb.grad.numpy(), np.asarray(jgrad)) < 5e-3


# ----------------------------------------------------------------------
# the MiniGPT-4 loss
# ----------------------------------------------------------------------
QUESTIONS = ["<Img><ImageHere></Img> what is it?", "<Img><ImageHere></Img> colour?",
             "<Img><ImageHere></Img> how many cats are there?", "<Img><ImageHere></Img> where?"]
ANSWERS = ["a cat", "red", "two", "in the kitchen"]


def _models(w8a8: bool):
    vit = dict(act_quant=w8a8, attn_impl="flash_cls" if w8a8 else "xla")
    cj = JM.MiniGPT4Config.tiny(vit=JV.EvaViTConfig.tiny(**vit),
                                llama=JLM.LlamaConfig.tiny(act_quant=w8a8))
    ct = TM.MiniGPT4Config.tiny(vit=TV.EvaViTConfig.tiny(**vit),
                                llama=TLM.LlamaConfig.tiny(act_quant=w8a8))
    params = JM.init_minigpt4(jax.random.PRNGKey(0), cj)
    if w8a8:
        params["vit"] = quantize_eva_vit(params["vit"])
        params["llama"] = quantize_llama(params["llama"])
    return cj, ct, jax.tree.map(np.asarray, params)


def _batch(cfg, pack: int, pad_last_row: bool = False, seq_len: int = 80):
    spec = JT.BatchSpec(seq_len=seq_len, num_img_tokens=cfg.num_img_tokens, max_answer_len=16)
    tok = JT.ByteTokenizer()
    if pack > 1:
        text = JT.pack_train_batch(tok, QUESTIONS, ANSWERS, spec, pack)
    else:
        text = JT.build_train_batch(tok, QUESTIONS, ANSWERS, spec)
    if pad_last_row:  # a row of pad slots only: segment id 0, no valid key
        for key, fill in (("input_ids", 0), ("attention_mask", 0), ("labels", -100),
                          ("segment_ids", 0), ("positions", 0)):
            text[key][-1] = fill
    img = cfg.vit.img_size
    images = np.random.RandomState(4).randn(len(QUESTIONS), img, img, 3).astype(np.float32)
    return {"image": images, **text}


@pytest.mark.parametrize("w8a8", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("pack", [1, 2])
def test_minigpt4_loss_and_projection_grad_match_jax(w8a8, pack):
    """The loss within 1e-5 relative (float) or 2e-3 (W8A8 towers: the ViT
    under the cls-split form with int8 activations, the W8A8 decoder), the
    ``llama_proj`` gradient within 1e-4 (float) or 2e-2 (W8A8; measured
    ~3e-3, the activation codes that flip change the gradient's
    summands); the packed loss equals the unpacked one on the same
    samples truncated alike (rows of 80 / pack slots) within 1e-5
    relative."""
    cj, ct, params = _models(w8a8)
    batch = _batch(cj, pack)
    trainable, frozen = JM.split_params(jax.tree.map(jnp.asarray, params))

    def jloss(tr):
        return JM.minigpt4_loss(JM.merge_params(tr, frozen), cj,
                                {k: jnp.asarray(v) for k, v in batch.items()})

    jval, jgrad = jax.value_and_grad(jloss)(trainable)
    model = MiniGPT4Model(ct, params_from_jax(params, ct, "cpu"), None)
    tr = model.make_trainable(("llama_proj",))
    assert all(p.requires_grad for p in tr["llama_proj"].values())
    assert not any(t.requires_grad for t in TL.tree_map(lambda a: a, model.params["llama"])
                   ["layers"]["q_proj"].values())
    tbatch = {k: torch.from_numpy(v) if v.dtype != np.int32 else torch.from_numpy(v).long()
              for k, v in batch.items()}
    loss = TM.minigpt4_loss(model.params, ct, tbatch)
    loss.backward()
    loss_tol, grad_tol = (2e-3, 2e-2) if w8a8 else (1e-5, 1e-4)
    assert abs(float(loss) - float(jval)) / abs(float(jval)) < loss_tol
    for key in ("kernel", "bias"):
        assert _rel(tr["llama_proj"][key].grad.numpy(),
                    np.asarray(jgrad["llama_proj"][key])) < grad_tol, key
    if pack > 1:
        unpacked = {k: torch.from_numpy(v) if v.dtype != np.int32 else torch.from_numpy(v).long()
                    for k, v in _batch(cj, 1, seq_len=80 // pack).items()}
        with torch.no_grad():
            ref = TM.minigpt4_loss(model.params, ct, unpacked)
        assert abs(float(loss) - float(ref)) / float(ref) < 1e-5


def test_packed_row_of_padding_gives_finite_gradients():
    """The last packed row holds only pad slots (every query fully masked):
    the loss is finite and equals the JAX package's, and the projection's
    gradient is finite and equals ``jax.grad``'s (the softmax's guard gives
    the masked rows zero weights and zero gradients, not NaN)."""
    cj, ct, params = _models(False)
    batch = _batch(cj, 2, pad_last_row=True)
    trainable, frozen = JM.split_params(jax.tree.map(jnp.asarray, params))
    jval, jgrad = jax.value_and_grad(lambda tr: JM.minigpt4_loss(
        JM.merge_params(tr, frozen), cj, {k: jnp.asarray(v) for k, v in batch.items()}))(trainable)
    model = MiniGPT4Model(ct, params_from_jax(params, ct, "cpu"), None)
    tr = model.make_trainable(("llama_proj",))
    tbatch = {k: torch.from_numpy(v) if v.dtype != np.int32 else torch.from_numpy(v).long()
              for k, v in batch.items()}
    loss = TM.minigpt4_loss(model.params, ct, tbatch)
    loss.backward()
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in tr["llama_proj"].values())
    assert abs(float(loss) - float(jval)) / abs(float(jval)) < 1e-5
    assert _rel(tr["llama_proj"]["kernel"].grad.numpy(),
                np.asarray(jgrad["llama_proj"]["kernel"])) < 1e-4


def test_split_and_merge_params():
    tree = {"vit": 1, "llama_proj": 2, "llama": 3}
    trainable, frozen = TM.split_params(tree, ("llama_proj",))
    assert trainable == {"llama_proj": 2} and frozen == {"vit": 1, "llama": 3}
    assert TM.merge_params(trainable, frozen) == tree
    assert TM.split_params(tree) == JM.split_params(tree)
