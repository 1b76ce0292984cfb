"""LLaMA/Vicuna decoder: the training forward and the cached (serving) mode.

Port of ``certifiedgpt_tpu/models/llama.py``: rotary, RMSNorm and SwiGLU as
in HF LLaMA, W8A8 on multi-token calls only (``act_quant``: prefill and
training; single-token decode keeps the weight-only path).

Without a cache (training), ``llama_apply`` runs causal self-attention over
the whole sequence, combined with the padding mask and, for packed rows,
with ``segment_ids`` (block-diagonal: a token sees only its own segment;
rotary positions are the caller's): ``ops/attention.py::training_attention``,
given the mask as its rows (``TrainingMask``), not as a dense [S, S] tensor.
Where autograd records, the lm_head's product is ``_LmHead``, whose backward
is the JAX VJP's (the f32 cotangent times the head in f32). ``remat``
recomputes blocks in the backward (``torch.utils.checkpoint``,
non-reentrant): ``remat_policy``
``full`` saves nothing, ``dots`` saves the outputs of the products without
a batch dimension (the projections), ``dots_all`` every product's (the
attention's too), ``remat_every`` k checkpoints the first block of every k.

With a cache, the per-layer KV cache (optionally int8 with per-(batch,
position, head) f32 scales) is updated in place, unlike the JAX package's
immutable arrays: ``llama_apply`` writes the new keys/values into the
tensors it is given and returns the same dict.

Every forward (training, a validation batch, the prefill, the decode
step) runs one block, ``_block``: the decoder's elementwise chains as the
fused ops of ``ops/elementwise.py`` (the residual add into the next RMSNorm
with the W8A8 input's int8 codes, shared by the products of that input;
the rotary of q and k; SiLU x up with the down input's codes), each
residual added by the norm after it. Where autograd records the forward
(training) the fused ops are ``torch.autograd.Function``s whose backward
runs the backward kernels.

Tensor parallelism (``run.model_parallel``): when the active mesh has a
model group (``parallel/mesh.py``), the parameters are this rank's shard
(``partition_llama``, Megatron layout) and the functions here run on it:
local heads and kv heads (read off the shards' widths), the row-split
o_proj/down_proj summed over the group (``parallel/tensor_parallel.py``),
the vocabulary-split embedding and lm_head, and a KV cache of this rank's
kv heads (its int8 scales are per (token, head), so they need no
collective).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils import checkpoint as _checkpoint

from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.ops import attention as A
from certifiedgpt_tpu_torch.ops import elementwise as E
from certifiedgpt_tpu_torch.ops import quantization as Q
from certifiedgpt_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    f32_product,
    gather_from_model,
    row_parallel_dense,
    tensor_parallel,
    vocab_parallel_embed,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # W8A8 on multi-token (prefill) calls when the layer kernels are int8
    act_quant: bool = False
    # int8 KV cache with per-row f32 scale sidecars
    kv_quant: bool = False
    # recompute decoder blocks in the backward (training forward only)
    remat: bool = False
    # what a recomputed block saves: "full" nothing, "dots" the products
    # without a batch dimension, "dots_all" every product
    remat_policy: str = "full"
    # checkpoint only the first block of every remat_every
    remat_every: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=4, max_position_embeddings=128,
            dtype=torch.float32,
        )
        base.update(overrides)
        return LlamaConfig(**base)


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    tp = tensor_parallel()
    if tp is not None:
        return vocab_parallel_embed(params["embed_tokens"]["embedding"], ids, tp)
    return L.embed(params["embed_tokens"], ids)


def _f32_times_t(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g [M, N] f32 @ w [K, N]^T`` in f32, w's values exact: on the card a
    bf16/f16 ``w`` stays in its dtype and ``g`` is split into three exact
    terms of that dtype (``hi``, ``mid``, ``lo``: 24 bits, the whole f32
    significand), each product summed in f32 (no f32 copy of ``w``);
    elsewhere ``w`` is cast to f32."""
    if g.device.type != "cuda" or w.dtype not in (torch.bfloat16, torch.float16):
        return g @ w.float().t()
    out, rest = None, g
    for _ in range(3):
        term = rest.to(w.dtype)
        rest = rest - term.float()
        part = torch.mm(term, w.t(), out_dtype=torch.float32)
        out = part if out is None else out + part
    return out


class _LmHead(torch.autograd.Function):
    """The lm_head product where autograd records it, as the JAX package's
    ``einsum(..., preferred_element_type=float32)`` and its VJP compute it:
    forward ``f32_product`` (bf16 x bf16 with an f32 output, no f32 copies);
    backward the f32 cotangent times the head in f32, rounded to the hidden
    rows' dtype (and, for a trainable head, the rows' transpose times the
    cotangent, rounded to the head's dtype). Saved: the rows and the head."""

    @staticmethod
    def forward(ctx, hidden2, kernel):
        ctx.save_for_backward(hidden2, kernel)
        return f32_product(hidden2, kernel)

    @staticmethod
    def backward(ctx, g):
        hidden2, kernel = ctx.saved_tensors
        gh = gk = None
        if ctx.needs_input_grad[0]:
            gh = _f32_times_t(g, kernel).to(hidden2.dtype)
        if ctx.needs_input_grad[1]:
            gk = _f32_times_t(g.t(), hidden2.t()).t().to(kernel.dtype)
        return gh, gk


def lm_head_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states [..., D] -> f32 vocabulary logits (+ the optional bias);
    under tensor parallelism this rank's vocabulary columns, gathered whole.
    bf16 operands on the card stay bf16 with an f32 output, as the JAX
    package's ``preferred_element_type=float32`` (no f32 copy of the head);
    where autograd records (training) the same product is ``_LmHead``, whose
    backward is the JAX VJP's."""
    tp = tensor_parallel()
    if tp is not None:
        hidden = copy_to_model(hidden, tp)
    kernel = params["lm_head"]["kernel"]
    hidden2 = hidden.reshape(-1, hidden.shape[-1])
    if torch.is_grad_enabled() and (hidden.requires_grad or kernel.requires_grad):
        logits = _LmHead.apply(hidden2, kernel)
    else:
        logits = f32_product(hidden2, kernel)
    logits = logits.reshape(*hidden.shape[:-1], kernel.shape[-1])
    if tp is not None:
        logits = gather_from_model(logits, tp)
    bias = params["lm_head"].get("bias")
    if bias is not None:
        logits = logits + bias.float()
    return logits


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device="cuda") -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Per-layer cache buffers ``[B, T, Hkv, Dh]`` (under tensor parallelism
    this rank's Hkv / model_parallel heads); with ``kv_quant`` int8 plus
    ``k_scale``/``v_scale`` ``[B, T, Hkv, 1]`` f32."""
    tp = tensor_parallel()
    kv_heads = cfg.num_kv_heads // (tp.n_model if tp is not None else 1)
    shape = (batch, max_len, kv_heads, cfg.head_dim)
    dtype = torch.int8 if cfg.kv_quant else cfg.dtype

    def bufs(shp, dt):
        return tuple(torch.zeros(shp, dtype=dt, device=device) for _ in range(cfg.num_layers))

    cache = {"k": bufs(shape, dtype), "v": bufs(shape, dtype)}
    if cfg.kv_quant:
        cache["k_scale"] = bufs(shape[:-1] + (1,), torch.float32)
        cache["v_scale"] = bufs(shape[:-1] + (1,), torch.float32)
    return cache


def _row_dense(params, inp, aq: bool, tp):
    """The o_proj/down_proj product: summed over the model group under
    tensor parallelism."""
    if tp is None:
        return L.dense(params, inp, act_quant=aq)
    return row_parallel_dense(params, inp, tp, act_quant=aq)


class TrainingMask(NamedTuple):
    """The mask of a forward without a cache, as ``training_attention``
    takes it: causal, with the keys' validity and the packed segments."""

    attention_mask: torch.Tensor  # [B, S], nonzero = a valid key
    segment_ids: Optional[torch.Tensor]  # [B, S] packed-segment ids, or None

    def rows(self, at) -> "TrainingMask":
        """The mask of the batch rows ``at`` (a slice)."""
        seg = self.segment_ids
        return TrainingMask(self.attention_mask[at], None if seg is None else seg[at])


def _attend(q, k, v, cfg: LlamaConfig, mask, cache, cache_offset):
    """The block's attention: over the S new rows (no cache: ``mask`` a
    ``TrainingMask``), or with the new keys/values written into the cache at
    ``cache_offset`` and over it (``mask`` a dense bool mask)."""
    if cache is None:
        return A.training_attention(q, k, v, mask.attention_mask, mask.segment_ids)
    if cfg.kv_quant and q.shape[1] == 1:
        # the decode step: the cache write and the attention in one launch
        return A.decode_attention_kv8(q, k, v, cache, cache_offset, mask)
    if cfg.kv_quant:
        # the prefill: the cache write and the attention in one launch
        return A.prefill_attention_kv8(q, k, v, cache, cache_offset, mask)
    A.write_slots(cache["k"], cache_offset, k)
    A.write_slots(cache["v"], cache_offset, v)
    return A.multi_head_attention(q, cache["k"], cache["v"], mask)


def _block(x, y, lp, cfg: LlamaConfig, cos, sin, positions, mask, cache=None,
           cache_offset=None):
    """A decoder block through the fused elementwise ops
    (``ops/elementwise.py``): ``y``, the previous block's down_proj output
    (None before the first block), is added into the residual stream ``x``
    by this block's input norm, and the o_proj output by its post-attention
    norm. Returns ``(x, y)``: the stream and this block's down_proj output,
    which the next norm adds. The same operations as the JAX package's
    block in the same order; differentiable where autograd records.

    On the W8A8 path (``act_quant``, several rows) each norm writes the
    int8 codes of its rows for the products that share them, and
    ``swiglu`` those of the down_proj's input. Under a model group the
    norms and ``swiglu`` write rows, which the column-parallel products
    share (quantized once where autograd does not record, by each product
    where it does) and ``row_parallel_dense`` quantizes itself."""
    b, s, _ = x.shape
    aq = cfg.act_quant and s > 1  # prefill and training; decode is bandwidth-bound
    tp = tensor_parallel()

    def int8(names):
        return aq and all("kernel_q" in lp[n] for n in names)

    def norm_then(x, y, norm, names):
        """``x + y`` into the norm ``norm``, then the products of ``names``
        on its output."""
        scale = lp[norm]["scale"]
        if tp is None and int8(names):
            return E.residual_norm(x, y, scale, cfg.rms_norm_eps, dense=[lp[n] for n in names])
        x, out = E.residual_norm(x, y, scale, cfg.rms_norm_eps)
        if tp is not None:
            out = copy_to_model(out, tp)
            if int8(names) and not (torch.is_grad_enabled() and out.requires_grad):
                xq, xs = Q.quantize_rows(out)
                return x, [L.dense_quantized(lp[n], xq, xs, x.dtype) for n in names]
        return x, [L.dense(lp[n], out, act_quant=aq) for n in names]

    x, qkv = norm_then(x, y, "input_layernorm", ("q_proj", "k_proj", "v_proj"))
    # heads from the shard widths: this rank's under tensor parallelism
    q, k, v = (t.reshape(b, s, -1, cfg.head_dim) for t in qkv)
    q, k = E.rotate_qk(q, k, cos, sin, positions)
    attn = _attend(q, k, v, cfg, mask, cache, cache_offset)
    o = _row_dense(lp["o_proj"], attn.reshape(b, s, -1), aq, tp)
    x, (gate, up) = norm_then(x, o, "post_attention_layernorm", ("gate_proj", "up_proj"))
    if tp is None and int8(("down_proj",)):
        return x, E.swiglu(gate, up, dense=lp["down_proj"])
    return x, _row_dense(lp["down_proj"], E.swiglu(gate, up), aq, tp)


# the products a recomputed block keeps under each of the JAX package's
# remat policies: "full" none, "dots" those without a batch dimension (the
# projections; the W8A8 ones on the CPU, where they are f32 products: on
# the card their kernel is no aten op and a recomputed block runs it
# again), "dots_all" the attention's too
_SAVED_PRODUCTS = {"full": (), "dots": ("mm", "addmm"),
                   "dots_all": ("mm", "addmm", "bmm", "baddbmm")}


def _remat_context(policy: str):
    """The ``context_fn`` of a block checkpointed under ``policy``: None
    for ``full`` (save nothing), else selective checkpointing that saves
    the outputs of the policy's products."""
    if policy not in _SAVED_PRODUCTS:
        raise ValueError(f"remat_policy={policy!r} not in {sorted(_SAVED_PRODUCTS)}")
    if not _SAVED_PRODUCTS[policy]:
        return None
    ops = {getattr(torch.ops.aten, name).default for name in _SAVED_PRODUCTS[policy]}

    def decide(ctx, op, *args, **kwargs):
        if op in ops:
            return _checkpoint.CheckpointPolicy.MUST_SAVE
        return _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: _checkpoint.create_selective_checkpoint_contexts(decide)


def _remat_settings(cfg: LlamaConfig):
    """``(every, context)`` of ``cfg.remat``'s checkpointing; refuses knobs
    that the JAX package refuses."""
    every = int(cfg.remat_every) if cfg.remat else 1
    if cfg.remat and cfg.num_layers % every:
        raise ValueError(f"remat_every={every} must divide num_layers={cfg.num_layers}")
    return every, (_remat_context(cfg.remat_policy) if cfg.remat else None)


def _run_layers(params, cfg: LlamaConfig, x, cos, sin, positions, mask):
    """The decoder blocks without a cache, with ``cfg.remat``'s
    checkpointing where autograd records. Returns ``(x, y)``: the stream
    and the last block's down_proj output, which the final norm adds."""
    every, context = _remat_settings(cfg)
    y = None
    for layer in range(cfg.num_layers):
        lp = L.layer_slice(params["layers"], layer)
        if cfg.remat and layer % every == 0 and torch.is_grad_enabled():
            kwargs = {} if context is None else {"context_fn": context}
            x, y = _checkpoint.checkpoint(_block, x, y, lp, cfg, cos, sin, positions, mask,
                                          use_reentrant=False, **kwargs)
        else:
            x, y = _block(x, y, lp, cfg, cos, sin, positions, mask)
    return x, y


def llama_apply(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D]
    attention_mask: torch.Tensor,  # [B, S] (no cache) or [B, max_len] 1 = valid
    positions: torch.Tensor,  # [B, S] rotary positions of the query tokens
    kv_cache: Optional[Dict[str, Tuple[torch.Tensor, ...]]] = None,
    cache_offset=None,  # int, or a 0-dim int32 tensor on the device (a decode step's slot)
    compute_logits: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] packed-segment ids
) -> Tuple[Optional[torch.Tensor], torch.Tensor, Optional[Dict[str, Tuple[torch.Tensor, ...]]]]:
    """Run the decoder. Returns ``(logits or None, final hidden, cache)``.

    Without a cache (training): causal self-attention over the S tokens,
    ``attention_mask`` [B, S] the padding validity, ``segment_ids`` (if
    given) isolating packed segments; the cache returned is None.

    With a cache: the S query tokens write their keys/values at
    ``cache_offset`` and attend over the whole cache; query i (position
    ``cache_offset + i``) sees slot j iff ``j <= cache_offset + i`` and the
    slot is valid. A decode step may give ``cache_offset`` as a 0-dim int32
    tensor on the device: the mask and the cache write read it there, so
    the step needs no host value and one CUDA graph serves every step."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    cos, sin = E.rotary_tables(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta,
                               device=device)
    x = inputs_embeds.to(cfg.dtype)
    if kv_cache is None:
        mask = TrainingMask(attention_mask, segment_ids)
    else:
        if segment_ids is not None:
            raise ValueError(
                "segment_ids (packed sequences) is a training-forward feature; "
                "cached prefill/decode is unpacked"
            )
        sk = kv_cache["k"][0].shape[1]
        q_pos = cache_offset + torch.arange(s, device=device)[:, None]
        k_pos = torch.arange(sk, device=device)[None, :]
        mask = (k_pos <= q_pos)[None, None] & attention_mask[:, None, None, :].bool()
    if kv_cache is None:
        x, y = _run_layers(params, cfg, x, cos, sin, positions, mask)
    else:
        y = None
        for layer in range(cfg.num_layers):
            x, y = _block(x, y, L.layer_slice(params["layers"], layer), cfg, cos, sin, positions,
                          mask, {name: cache[layer] for name, cache in kv_cache.items()},
                          cache_offset)
    # the last down_proj output is added by the final norm
    _, x = E.residual_norm(x, y, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = lm_head_logits(params, x) if compute_logits else None
    return logits, x, kv_cache


IGNORE_INDEX = -100


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] with IGNORE_INDEX masking
    label_smoothing: float = 0.1,
    reduction: str = "mean",
) -> torch.Tensor:
    """Label-smoothed CE with the causal shift (logits[:, :-1] against
    labels[:, 1:]), in f32. ``mean``: over every valid token of the batch;
    ``none``: each sample's mean over its valid tokens; ``sum``: each
    sample's sum over its valid tokens (the JAX package's definitions)."""
    logits = logits[:, :-1, :].float()
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    per_token = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    per_token = torch.where(valid, per_token, 0.0)
    counts = valid.sum(dim=-1)
    if reduction == "none":
        return per_token.sum(dim=-1) / counts.clamp_min(1)
    if reduction == "sum":
        return per_token.sum(dim=-1)
    return per_token.sum() / counts.sum().clamp_min(1)


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = L.ParamTree(params)

    def forward(self, inputs_embeds, attention_mask, positions, kv_cache=None,
                cache_offset=None, compute_logits=True, segment_ids=None):
        return llama_apply(self.params.tree(), self.cfg, inputs_embeds, attention_mask,
                           positions, kv_cache, cache_offset, compute_logits, segment_ids)
