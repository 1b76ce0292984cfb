"""MiniGPT-4 assembly: EVA ViT -> ln_vision -> Q-Former -> llama_proj -> decoder.

Port of ``certifiedgpt_tpu/models/minigpt4.py``: ``encode_img``, the
embedding assembly (``assemble_embeds``, and ``assemble_packed_embeds`` for
packed training rows), the training loss ``minigpt4_loss``,
``split_params``/``merge_params``, ``generate`` with the KV cache (greedy,
or nucleus sampling with a temperature, the repetition penalty and
``min_length``) and ``early_exit``, ``generate_beam`` (beam search) and
``rank_answers`` (candidate answers ranked by their loss). Generation
prompts are left-padded, so every row's last prompt token sits at slot S-1
and decoding proceeds from one cache offset; training rows are
right-padded. Sampling draws from an explicit ``torch.Generator`` (the
Gumbel-max draw of ``jax.random.categorical``; the streams differ, the
distribution is the same).

``early_exit`` never waits for the device: the JAX package ends its decode
loop on the device (``lax.while_loop``); here each step queues a copy of
"every row is done" into pinned host memory with an event behind it, and
the host stops launching steps once a copy whose event has completed reads
true. An exit seen late is exact: a step after every row is done writes
``pad`` where the output already holds ``pad``.

The parameter tree is ``{"vit", "ln_vision", "qformer", "llama_proj",
"llama"}`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from certifiedgpt_tpu_torch.common.stages import StageClock, stage
from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig, eva_vit_apply
from certifiedgpt_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
    embed_tokens,
    init_kv_cache,
    llama_apply,
    lm_head_logits,
)
from certifiedgpt_tpu_torch.models.qformer import QFormer, QFormerConfig, qformer_apply
from certifiedgpt_tpu_torch.ops.quantization import ieee_div


@dataclasses.dataclass(frozen=True)
class MiniGPT4Config:
    vit: EvaViTConfig = dataclasses.field(default_factory=EvaViTConfig.eva_vit_g)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig.blip2)
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    max_txt_len: int = 160
    max_context_len: int = 3800
    label_smoothing: float = 0.1

    @staticmethod
    def tiny(**overrides) -> "MiniGPT4Config":
        vit = EvaViTConfig.tiny()
        base = dict(
            vit=vit,
            qformer=QFormerConfig.tiny(encoder_width=vit.embed_dim),
            llama=LlamaConfig.tiny(),
            max_txt_len=16,
            max_context_len=128,
        )
        base.update(overrides)
        return MiniGPT4Config(**base)

    @property
    def num_img_tokens(self) -> int:
        return self.qformer.num_query_tokens


def encode_img(params: Dict[str, Any], cfg: MiniGPT4Config, images: torch.Tensor,
               clock: Optional[StageClock] = None) -> torch.Tensor:
    """images [B, H, W, C] -> projected image tokens [B, 32, llama_hidden]."""
    with stage(clock, "vit"):
        feats = eva_vit_apply(params["vit"], cfg.vit, images)
    with stage(clock, "qformer"):
        # ln_vision is a plain nn.LayerNorm in the reference: eps 1e-5,
        # not the ViT's 1e-6
        feats = L.layer_norm(params["ln_vision"], feats, eps=1e-5)
        queries = qformer_apply(params["qformer"], cfg.qformer, feats)
        out = L.dense(params["llama_proj"], queries.float())
        return out.to(cfg.llama.dtype)


def assemble_embeds(params: Dict[str, Any], cfg: MiniGPT4Config,
                    input_ids: torch.Tensor,  # [B, S]
                    img_embeds: torch.Tensor,  # [B, T_img, D]
                    img_pos: torch.Tensor,  # [B] start slot of the image span
                    ) -> torch.Tensor:
    text = embed_tokens(params["llama"], input_ids)
    t_img = img_embeds.shape[1]
    slots = img_pos[:, None] + torch.arange(t_img, device=text.device)[None, :]
    rows = torch.arange(text.shape[0], device=text.device)[:, None]
    text[rows, slots] = img_embeds.to(text.dtype)
    return text


def assemble_packed_embeds(params: Dict[str, Any], cfg: MiniGPT4Config,
                           input_ids: torch.Tensor,  # [R, S] packed rows
                           img_embeds: torch.Tensor,  # [R, K, T_img, D] one image a segment
                           img_pos: torch.Tensor,  # [R, K] image span start of each segment
                           ) -> torch.Tensor:
    """``assemble_embeds`` for packed rows (``data/text.pack_train_batch``):
    each of a row's K segments gets its own image span. A span start is
    clamped so that the span fits the row, as JAX's
    ``dynamic_update_slice`` clamps it."""
    text = embed_tokens(params["llama"], input_ids)
    s, t_img = text.shape[1], img_embeds.shape[2]
    start = img_pos.long().clamp(0, s - t_img)
    slots = start[:, :, None] + torch.arange(t_img, device=text.device)
    rows = torch.arange(text.shape[0], device=text.device)[:, None, None]
    text[rows, slots] = img_embeds.to(text.dtype)
    return text


TRAINABLE_DEFAULT = ("llama_proj",)


def split_params(params: Dict[str, Any], trainable_keys: Tuple[str, ...] = TRAINABLE_DEFAULT
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition the tree into (trainable, frozen) by top-level key."""
    trainable = {k: v for k, v in params.items() if k in trainable_keys}
    frozen = {k: v for k, v in params.items() if k not in trainable_keys}
    return trainable, frozen


def merge_params(trainable: Dict[str, Any], frozen: Dict[str, Any]) -> Dict[str, Any]:
    return {**frozen, **trainable}


def minigpt4_loss(params: Dict[str, Any], cfg: MiniGPT4Config, batch: Dict[str, torch.Tensor],
                  reduction: str = "mean", img_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Label-smoothed CE on the answer tokens (-100 outside the answer
    span). ``batch``: image [B,H,W,C], input_ids, attention_mask, labels
    [B,S], img_pos [B]; a packed batch (``data/text.pack_train_batch``)
    carries segment_ids and positions [R,S] and img_pos [R,K] for B = R*K
    images, and runs block-diagonal attention with per-segment rotary
    positions. ``img_embeds`` skips the vision tower. Rotary positions
    past the decoder's table raise (the JAX package would give NaN)."""
    if img_embeds is None:
        img_embeds = encode_img(params, cfg, batch["image"])
    table = cfg.llama.max_position_embeddings
    if "segment_ids" in batch:
        rows, k = batch["img_pos"].shape
        seg_budget = batch["input_ids"].shape[1] // k
        if seg_budget > table:
            raise ValueError(
                f"run.seq_len//pack_sequences={seg_budget} exceeds the decoder's "
                f"max_position_embeddings={table}; packed per-segment rotary positions "
                f"past the table would silently NaN"
            )
        embeds = assemble_packed_embeds(
            params, cfg, batch["input_ids"],
            img_embeds.reshape(rows, k, *img_embeds.shape[1:]), batch["img_pos"],
        )
        positions, segment_ids = batch["positions"].long(), batch["segment_ids"]
    else:
        embeds = assemble_embeds(params, cfg, batch["input_ids"], img_embeds, batch["img_pos"])
        if embeds.shape[1] > table:
            raise ValueError(
                f"run.seq_len={embeds.shape[1]} exceeds the decoder's "
                f"max_position_embeddings={table}; rotary positions past the table "
                f"would silently NaN"
            )
        positions = torch.arange(embeds.shape[1], device=embeds.device).expand(embeds.shape[:2])
        segment_ids = None
    logits, _, _ = llama_apply(params["llama"], cfg.llama, embeds, batch["attention_mask"],
                               positions, segment_ids=segment_ids)
    return cross_entropy_loss(logits, batch["labels"], cfg.label_smoothing, reduction=reduction)


class _DoneFlags:
    """Whether every row is done after each decode step, on its way to the
    host.

    ``record`` queues ``done.all()`` into one slot of a host buffer (pinned
    on the card, copied with ``non_blocking``) and records an event behind
    the copy; ``seen_all_done`` reads only the slots whose events have
    completed (``Event.query``, which does not wait). On the CPU the copy
    is done when ``record`` returns."""

    def __init__(self, steps: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = torch.zeros((steps,), dtype=torch.bool, pin_memory=self.cuda)
        self.events = []
        self.read = 0  # slots read so far, all false

    def record(self, done: torch.Tensor) -> None:
        self.host[len(self.events)].copy_(done.all(), non_blocking=True)
        event = torch.cuda.Event() if self.cuda else None
        if event is not None:
            event.record()
        self.events.append(event)

    def seen_all_done(self) -> bool:
        while self.read < len(self.events):
            event = self.events[self.read]
            if event is not None and not event.query():
                return False
            if bool(self.host[self.read]):
                return True
            self.read += 1
        return False


_F32_MIN = torch.finfo(torch.float32).min


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest prefix of the sorted probabilities whose mass
    reaches ``top_p`` (ties with the last kept logit kept too); every other
    logit becomes the f32 minimum. ``logits`` [B, V] f32."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, last)
    return torch.where(logits < cutoff, _F32_MIN, logits)


def select_token(logits: torch.Tensor, *, do_sample: bool, temperature: float, top_p: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The next token of each row of ``logits`` [B, V] f32: the argmax, or
    with ``do_sample`` a draw from the softmax of the logits over
    ``temperature`` after the nucleus filter (``top_p`` < 1), drawn as
    ``argmax(logits + Gumbel noise)`` from ``generator``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = ieee_div(logits, max(temperature, 1e-6))
    if top_p < 1.0:
        logits = nucleus_filter(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF convention: the logits of tokens seen so far (``counts`` > 0) are
    divided by ``penalty`` where positive and multiplied where negative."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, ieee_div(logits, penalty), logits * penalty)
    return torch.where(counts > 0, penalized, logits)


def prefill(params, cfg: MiniGPT4Config, batch, max_new_tokens: int,
            clock: Optional[StageClock] = None):
    """Encode the images and run the prompt through the decoder into a new
    KV cache. Returns the last position's hidden state [B, D], the cache,
    its validity mask [B, S + max_new_tokens], the prompt length S and each
    row's next rotary position."""
    img_embeds = encode_img(params, cfg, batch["image"], clock)
    with stage(clock, "prefill"):
        embeds = assemble_embeds(params, cfg, batch["input_ids"], img_embeds, batch["img_pos"])
        b, s, _ = embeds.shape
        device = embeds.device
        mask = batch["attention_mask"].to(torch.int32)
        # rotary positions: left pads get 0, real tokens count up
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
        cache = init_kv_cache(cfg.llama, b, s + max_new_tokens, device)
        # decode slots are marked valid up front; causal masking hides the
        # unwritten ones
        cache_mask = torch.cat(
            [mask, torch.ones((b, max_new_tokens), dtype=torch.int32, device=device)], dim=1
        )
        # only the last position's logits are needed after the prefill
        _, hidden, cache = llama_apply(params["llama"], cfg.llama, embeds, cache_mask,
                                       positions, cache, 0, compute_logits=False)
        return hidden[:, -1, :], cache, cache_mask, s, mask.sum(dim=1).long()


def generate(
    params: Dict[str, Any],
    cfg: MiniGPT4Config,
    batch: Dict[str, torch.Tensor],
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    *,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 0.9,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    early_exit: bool = False,
    clock: Optional[StageClock] = None,
) -> torch.Tensor:
    """Decode with a KV cache: greedy by default; ``do_sample`` draws from
    the nucleus (``top_p``) of the softmax at ``temperature`` with
    ``generator`` (one seeded 0 on the batch's device when None); a
    ``repetition_penalty`` other than 1 penalizes every token emitted so
    far; EOS cannot be emitted before ``min_length`` tokens. ``batch``
    holds a left-padded prompt: image [B, H, W, C], input_ids [B, S],
    attention_mask [B, S], img_pos [B].

    Returns [B, max_new_tokens] token ids, ``pad_token_id`` after a row's
    EOS. ``early_exit`` stops launching decode steps once the host sees,
    without waiting, that every row has emitted EOS (``_DoneFlags``); the
    output is identical to the full loop's. ``generate.decode_steps``
    counts the decode steps launched."""
    last, cache, cache_mask, s, prompt_len = prefill(params, cfg, batch, max_new_tokens, clock)
    b, device = last.shape[0], last.device
    if do_sample and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    # the repetition penalty's table of the tokens emitted so far
    counts = (torch.zeros((b, cfg.llama.vocab_size), dtype=torch.int32, device=device)
              if repetition_penalty != 1.0 else None)

    def pick(logits: torch.Tensor, t: int) -> torch.Tensor:
        """Token ``t`` (0-based) of each row."""
        if counts is not None:
            logits = apply_repetition_penalty(logits, counts, repetition_penalty)
        if t + 1 < min_length:
            logits = logits.clone()
            logits[:, eos_token_id] = _F32_MIN
        token = select_token(logits, do_sample=do_sample, temperature=temperature,
                             top_p=top_p, generator=generator)
        if counts is not None:
            counts.scatter_add_(1, token[:, None], torch.ones_like(token[:, None],
                                                                   dtype=torch.int32))
        return token

    with stage(clock, "prefill"):
        token = pick(lm_head_logits(params["llama"], last), 0)

    with stage(clock, "decode"):
        out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
        positions = prompt_len
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        flags = _DoneFlags(max_new_tokens, device) if early_exit else None
        for t in range(max_new_tokens):
            if flags is not None and flags.seen_all_done():
                break
            out[:, t] = torch.where(done, pad_token_id, token)
            done = done | (token == eos_token_id)
            if t == max_new_tokens - 1:
                break  # the next token would fall outside the output
            if flags is not None:
                flags.record(done)
            generate.decode_steps += 1
            if clock is not None:
                clock.count("decode_step")
            tok_embed = embed_tokens(params["llama"], token[:, None])
            logits, _, cache = llama_apply(params["llama"], cfg.llama, tok_embed, cache_mask,
                                           positions[:, None], cache, s + t)
            new_token = pick(logits[:, -1, :], t + 1)
            token = torch.where(done, eos_token_id, new_token)
            positions = positions + 1
        return out


generate.decode_steps = 0


def generate_greedy(params, cfg, batch, max_new_tokens, eos_token_id, pad_token_id=0,
                    early_exit: bool = False, clock: Optional[StageClock] = None):
    """Greedy decode (the certification hot path)."""
    return generate(params, cfg, batch, max_new_tokens, eos_token_id, pad_token_id,
                    early_exit=early_exit, clock=clock)


def generate_beam(
    params: Dict[str, Any],
    cfg: MiniGPT4Config,
    batch: Dict[str, torch.Tensor],
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    *,
    num_beams: int = 3,
    length_penalty: float = 1.0,
) -> torch.Tensor:
    """Beam search with a KV cache. The prompt is prefilled once a row and
    its cache repeated for each beam; beams are flattened into the batch
    axis, every step is one cached forward and a top-k over
    [beams * vocab] a row, and on reorder the cache (the int8 codes and
    their scales too) is gathered by parent beam. A finished beam extends
    only with EOS at no cost, so its score is frozen. The winner maximizes
    ``score / generated_length ** length_penalty`` (the JAX package's
    normalization by generated tokens; HF divides by the whole length).
    Returns [B, max_new_tokens] token ids of each row's best beam."""
    last, cache, cache_mask, s, prompt_len = prefill(params, cfg, batch, max_new_tokens)
    b, device, k = last.shape[0], last.device, num_beams
    logp0 = torch.log_softmax(lm_head_logits(params["llama"], last), dim=-1)  # [B, V]
    vocab = logp0.shape[-1]
    top_logp, top_tok = torch.topk(logp0, k, dim=-1)  # [B, K]

    cache = {name: tuple(buf.repeat_interleave(k, dim=0) for buf in bufs)
             for name, bufs in cache.items()}
    flat_mask = cache_mask.repeat_interleave(k, dim=0)  # [B*K, S + max_new_tokens]
    scores = top_logp.reshape(b * k)  # cumulative log-probability of each beam
    tokens = top_tok.reshape(b * k)
    done = tokens == eos_token_id
    lengths = torch.ones((b * k,), dtype=torch.int32, device=device)
    out = torch.full((b * k, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    out[:, 0] = tokens
    positions = prompt_len.repeat_interleave(k, dim=0)  # next rotary position
    eos_only = torch.full((vocab,), -1e30, dtype=torch.float32, device=device)
    eos_only[eos_token_id] = 0.0
    rows = torch.arange(b, device=device)[:, None] * k

    for t in range(max_new_tokens - 1):
        tok_embed = embed_tokens(params["llama"], tokens[:, None])
        logits, _, cache = llama_apply(params["llama"], cfg.llama, tok_embed, flat_mask,
                                       positions[:, None], cache, s + t)
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        logp = torch.where(done[:, None], eos_only[None, :], logp)
        cand = (scores[:, None] + logp).reshape(b, k * vocab)
        new_scores, flat_idx = torch.topk(cand, k, dim=-1)  # [B, K]
        gather = (rows + flat_idx // vocab).reshape(b * k)  # parent beam, flattened
        cache = {name: tuple(buf.index_select(0, gather) for buf in bufs)
                 for name, bufs in cache.items()}
        out, done = out[gather], done[gather]
        lengths, positions = lengths[gather], positions[gather]
        tokens = (flat_idx % vocab).reshape(b * k)
        out[:, t + 1] = torch.where(done, pad_token_id, tokens)
        lengths = lengths + (~done).to(torch.int32)
        done = done | (tokens == eos_token_id)
        scores = new_scores.reshape(b * k)
        positions = positions + 1

    norm = scores.reshape(b, k) / lengths.reshape(b, k).float() ** length_penalty
    best = torch.argmax(norm, dim=-1)
    return out.reshape(b, k, max_new_tokens)[torch.arange(b, device=device), best]


def rank_answers(params: Dict[str, Any], cfg: MiniGPT4Config,
                 batches: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Rank candidate answers per sample by their loss: ``batches`` maps
    each candidate to a training-layout batch in which every sample has
    that candidate as its answer; returns [B, n_candidates] candidate
    indices, best first (a stable sort). The score is each sample's sum of
    token losses (the reference averages over the whole padded length, a
    divisor shared by every candidate, so its order is the sum's). The
    vision tower runs once: every candidate batch carries the same
    images."""
    losses, img_embeds = [], None
    for cand_batch in batches.values():
        if img_embeds is None:
            img_embeds = encode_img(params, cfg, cand_batch["image"])
        losses.append(minigpt4_loss(params, cfg, cand_batch, reduction="sum",
                                    img_embeds=img_embeds))
    return torch.argsort(torch.stack(losses, dim=-1), dim=-1, stable=True)


class MiniGPT4(nn.Module):
    """The whole model as modules, one per tower, with parameters in the
    JAX layout; ``tree()`` gives the parameter dict the functions take."""

    def __init__(self, cfg: MiniGPT4Config, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.vit = EvaViT(cfg.vit, params["vit"])
        self.ln_vision = L.ParamTree(params["ln_vision"])
        self.qformer = QFormer(cfg.qformer, params["qformer"])
        self.llama_proj = L.ParamTree(params["llama_proj"])
        self.llama = Llama(cfg.llama, params["llama"])

    def tree(self) -> Dict[str, Any]:
        return {
            "vit": self.vit.params.tree(),
            "ln_vision": self.ln_vision.tree(),
            "qformer": self.qformer.params.tree(),
            "llama_proj": self.llama_proj.tree(),
            "llama": self.llama.params.tree(),
        }
