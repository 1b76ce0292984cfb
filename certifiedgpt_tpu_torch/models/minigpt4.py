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

``early_exit`` never synchronizes with the device (under tensor
parallelism over more than one rank it is off: the ranks of a model group
must launch the same steps, and each sees its flags land at its own time;
the tokens do not change): the JAX package ends its decode loop on the
device (``lax.while_loop``); here each step queues a copy of "every row is
done" into pinned host memory with an event behind it, and the host stops
launching steps once a copy whose event has completed reads true. A
replayed step takes the host a small fraction of the card's time, so the
host keeps at most ``_DoneFlags.AHEAD`` steps queued beyond the flags it
has seen, polling their events (``Event.query``, which PyTorch does not
count as a synchronization; the card always has a step queued). An exit
seen late is exact: a step after every row is done writes ``pad`` where
the output already holds ``pad``.

The decode step is one function of fixed tensors (``_decode_step``) that
reads its step index and cache slot on the device; on the card it is
captured once into a CUDA graph and replayed for every step
(``_decode_graphs``, ``common/graphs.py``), the counterpart of the JAX
package's compiled loop.

The parameter tree is ``{"vit", "ln_vision", "qformer", "llama_proj",
"llama"}`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn

from certifiedgpt_tpu_torch.common.graphs import Captured, GraphStore
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
from certifiedgpt_tpu_torch.ops import quantization as Q
from certifiedgpt_tpu_torch.ops.quantization import ieee_div
from certifiedgpt_tpu_torch.parallel.tensor_parallel import tensor_parallel


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


def decoder_inputs(params: Dict[str, Any], cfg: MiniGPT4Config, batch: Dict[str, torch.Tensor],
                   img_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The decoder's inputs of a train batch: ``(inputs_embeds, positions,
    segment_ids or None)``. ``batch``: image [B,H,W,C], input_ids,
    attention_mask, labels [B,S], img_pos [B]; a packed batch
    (``data/text.pack_train_batch``) carries segment_ids and positions
    [R,S] and img_pos [R,K] for B = R*K images, whose rows run
    block-diagonal attention with per-segment rotary positions.
    ``img_embeds`` skips the vision tower. Rotary positions past the
    decoder's table raise (the JAX package would give NaN)."""
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
        return embeds, batch["positions"].long(), batch["segment_ids"]
    embeds = assemble_embeds(params, cfg, batch["input_ids"], img_embeds, batch["img_pos"])
    if embeds.shape[1] > table:
        raise ValueError(
            f"run.seq_len={embeds.shape[1]} exceeds the decoder's "
            f"max_position_embeddings={table}; rotary positions past the table "
            f"would silently NaN"
        )
    return embeds, torch.arange(embeds.shape[1], device=embeds.device).expand(
        embeds.shape[:2]), None


def minigpt4_loss(params: Dict[str, Any], cfg: MiniGPT4Config, batch: Dict[str, torch.Tensor],
                  reduction: str = "mean", img_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Label-smoothed CE on the answer tokens (-100 outside the answer
    span) of a train batch (``decoder_inputs``: packed or not; its
    ``img_embeds`` skips the vision tower)."""
    embeds, positions, segment_ids = decoder_inputs(params, cfg, batch, img_embeds)
    logits, _, _ = llama_apply(params["llama"], cfg.llama, embeds, batch["attention_mask"],
                               positions, segment_ids=segment_ids)
    return cross_entropy_loss(logits, batch["labels"], cfg.label_smoothing, reduction=reduction)


class _DoneFlags:
    """Whether every row is done after each decode step, on its way to the
    host.

    ``record`` queues ``done.all()`` into one slot of a host buffer (pinned
    on the card, copied with ``non_blocking``) and records an event behind
    the copy; ``seen_all_done`` reads only the slots whose events have
    completed (``Event.query``, which does not wait), and while ``AHEAD``
    or more recorded slots have not landed it polls the oldest one's event
    until it has. On the CPU the copy is done when ``record`` returns."""

    # steps the host keeps queued beyond the flags it has seen, and the
    # pause between two polls of an event
    AHEAD = 2
    POLL_S = 2e-5

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
                if len(self.events) - self.read < self.AHEAD:
                    return False
                time.sleep(self.POLL_S)
                continue
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
            clock: Optional[StageClock] = None, cache=None):
    """Encode the images and run the prompt through the decoder into a KV
    cache: a new one, or ``cache`` (``init_kv_cache``'s layout for
    ``S + max_new_tokens`` slots), whose slots past the prompt may hold an
    earlier call's rows: a decode step's causal mask hides every slot after
    its own, so none of them is ever read. Returns the last position's
    hidden state [B, D], the cache, its validity mask [B, S +
    max_new_tokens], the prompt length S and each row's next rotary
    position."""
    img_embeds = encode_img(params, cfg, batch["image"], clock)
    with stage(clock, "prefill"):
        embeds = assemble_embeds(params, cfg, batch["input_ids"], img_embeds, batch["img_pos"])
        b, s, _ = embeds.shape
        device = embeds.device
        mask = batch["attention_mask"].to(torch.int32)
        # rotary positions: left pads get 0, real tokens count up
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
        if cache is None:
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


@dataclasses.dataclass(frozen=True)
class _Knobs:
    """What a decode step does besides the decoder: the token choice and
    the ids it writes."""
    eos: int
    pad: int
    do_sample: bool
    temperature: float
    top_p: float
    min_length: int
    repetition_penalty: float


class _DecodeState(Captured):
    """The tensors a decode step reads and updates in place: the KV cache
    and its mask, each row's current token, next rotary position and done
    flag, the output ids, the step index ``t`` (0-dim int32 on the device)
    and the repetition penalty's table of emitted tokens. A captured step
    (``graph``) reads and writes these same tensors at every replay;
    ``generator`` is the sampling generator registered with the graph."""

    def __init__(self, cfg: MiniGPT4Config, b: int, s: int, max_new_tokens: int,
                 knobs: _Knobs, device: torch.device):
        super().__init__()
        self.cache = init_kv_cache(cfg.llama, b, s + max_new_tokens, device)
        self.cache_mask = torch.ones((b, s + max_new_tokens), dtype=torch.int32, device=device)
        self.token = torch.zeros((b,), dtype=torch.long, device=device)
        self.positions = torch.zeros((b,), dtype=torch.long, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.out = torch.zeros((b, max_new_tokens), dtype=torch.long, device=device)
        self.t = torch.zeros((), dtype=torch.int32, device=device)
        # the table of the tokens emitted so far (the repetition penalty's)
        self.counts = (torch.zeros((b, cfg.llama.vocab_size), dtype=torch.int32, device=device)
                       if knobs.repetition_penalty != 1.0 else None)
        self.s = s
        self.generator: Optional[torch.Generator] = None

    def small(self):
        """The state beside the cache (what a warm-up step changes)."""
        return [x for x in (self.token, self.positions, self.done, self.out, self.t,
                            self.counts) if x is not None]


def _pick(logits: torch.Tensor, t, knobs: _Knobs, counts: Optional[torch.Tensor],
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Token ``t`` (0-based; an int, or a 0-dim tensor on the device) of
    each row from ``logits`` [B, V] f32: the repetition penalty, EOS held
    back while ``t + 1 < min_length`` (a ``where`` on ``t``, as the JAX
    package's), the choice, and the choice counted in ``counts``."""
    if counts is not None:
        logits = apply_repetition_penalty(logits, counts, knobs.repetition_penalty)
    if knobs.min_length > 1:
        eos_col = torch.arange(logits.shape[-1], device=logits.device) == knobs.eos
        logits = torch.where(eos_col & (t + 1 < knobs.min_length), _F32_MIN, logits)
    token = select_token(logits, do_sample=knobs.do_sample, temperature=knobs.temperature,
                         top_p=knobs.top_p, generator=generator)
    if counts is not None:
        counts.scatter_add_(1, token[:, None], torch.ones_like(token[:, None], dtype=torch.int32))
    return token


def _decode_step(params, cfg: MiniGPT4Config, st: _DecodeState, knobs: _Knobs,
                 generator: Optional[torch.Generator]) -> None:
    """One decode step, in place on ``st`` and with no host value (the JAX
    package's ``step``): column ``t`` of the output takes the current token
    (``pad`` once the row is done), the row is done once that token is EOS,
    the decoder runs the token at cache slot ``s + t``, and the next token
    (EOS once done) replaces it; ``positions`` and ``t`` move on by one."""
    t = st.t
    st.out.index_copy_(1, t.long().reshape(1), torch.where(st.done, knobs.pad, st.token)[:, None])
    st.done |= st.token == knobs.eos
    tok_embed = embed_tokens(params["llama"], st.token[:, None])
    logits, _, _ = llama_apply(params["llama"], cfg.llama, tok_embed, st.cache_mask,
                               st.positions[:, None], st.cache, t + st.s)
    new_token = _pick(logits[:, -1, :], t + 1, knobs, st.counts, generator)
    st.token.copy_(torch.where(st.done, knobs.eos, new_token))
    st.positions += 1
    st.t += 1


def _step_functions() -> Tuple:
    """The kernel entries a decode step reaches through its modules'
    attributes, as they are bound now: a capture serves only the functions
    it recorded (a caller that routes them to their plain versions gets a
    capture of its own)."""
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import elementwise as E

    return (A.decode_attention_kv8, A.prefill_attention_kv8, A.multi_head_attention_kv8,
            Q.int8_weight_forward, Q.quantize_rows, Q.w8a8_product, Q.w8a8_epilogue,
            E.add_rms_norm,
            E.rotary, E.silu_mul)


def _decode_graphs(params) -> GraphStore:
    """A model's captured decode steps (at most two), kept as an attribute
    of its ``lm_head`` weight tensor, so the captures and their pool go
    with the model's weights."""
    head = params["llama"]["lm_head"]["kernel"]
    graphs = getattr(head, "_cgpt_decode_graphs", None)
    if graphs is None:
        graphs = head._cgpt_decode_graphs = GraphStore(most=2)
    return graphs


def _count_step(clock: Optional[StageClock]) -> None:
    generate.decode_steps += 1
    if clock is not None:
        clock.count("decode_step")


class _Decode:
    """One ``generate`` call's decode: the prefill into the state's cache,
    the first token, then ``step`` once for each later token, replayed
    from the state's CUDA graph or run eagerly (on the CPU, under tensor
    parallelism, or when the caller asks for it)."""

    def __init__(self, params, cfg: MiniGPT4Config, batch, max_new_tokens: int, knobs: _Knobs,
                 generator: Optional[torch.Generator], clock: Optional[StageClock],
                 cuda_graph: bool):
        b, s = batch["input_ids"].shape
        device = batch["input_ids"].device
        self.params, self.cfg, self.knobs, self.clock = params, cfg, knobs, clock
        self.generator = generator
        graphed = cuda_graph and device.type == "cuda" and tensor_parallel() is None
        make = lambda: _DecodeState(cfg, b, s, max_new_tokens, knobs, device)  # noqa: E731
        if graphed:
            key = (b, s, max_new_tokens, cfg.llama, knobs, device, _step_functions(),
                   L.tree_addresses(params["llama"]))
            st = _decode_graphs(params).state(key, make)
        else:
            st = make()
        self.st, self.graphed = st, graphed
        last, _, cache_mask, _, prompt_len = prefill(params, cfg, batch, max_new_tokens, clock,
                                                     cache=st.cache)
        with stage(clock, "prefill"):
            st.cache_mask.copy_(cache_mask)
            if st.counts is not None:
                st.counts.zero_()
            st.token.copy_(_pick(lm_head_logits(params["llama"], last), 0, knobs, st.counts,
                                 generator))
        with stage(clock, "decode"):
            st.positions.copy_(prompt_len)
            st.done.zero_()
            st.out.fill_(knobs.pad)
            st.t.zero_()
            if graphed and knobs.do_sample and st.generator is None:
                st.generator = torch.Generator(device=device)
            if graphed and st.graph is None and max_new_tokens > 1:
                self._capture()
            if st.generator is not None:
                # the captured draws continue the caller's generator
                st.generator.set_state(generator.get_state())

    def _capture(self) -> None:
        """Capture the step on the state (``GraphStore.capture``): its
        warm-up is a real step, counted as one, after which the state
        beside the cache is put back (the cache slot it wrote is the one
        the first replay writes again)."""
        st = self.st
        kept = [x.clone() for x in st.small()]

        def restore():
            for x, was in zip(st.small(), kept):
                x.copy_(was)

        _decode_graphs(self.params).capture(st, self._body, restore, st.t.device, st.generator)
        _count_step(self.clock)
        generate.captures += 1

    def _body(self) -> None:
        _decode_step(self.params, self.cfg, self.st, self.knobs,
                     self.st.generator if self.graphed else self.generator)

    def step(self) -> None:
        """The next decode step: a replay (which adds its captured launches
        to the kernels' counters), or the step run eagerly."""
        _count_step(self.clock)
        if self.graphed:
            self.st.replay()
        else:
            self._body()

    def finish(self, steps_run: int) -> torch.Tensor:
        """The output ids after ``steps_run`` steps (a copy: the state is
        reused); after every step, the last column takes the last token."""
        st = self.st
        last = st.out.shape[1] - 1
        if steps_run == last:
            st.out[:, last] = torch.where(st.done, self.knobs.pad, st.token)
        if st.generator is not None:
            self.generator.set_state(st.generator.get_state())
        return st.out.clone() if self.graphed else st.out


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
    cuda_graph: bool = True,
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
    without a synchronization, that every row has emitted EOS
    (``_DoneFlags``: at most ``_DoneFlags.AHEAD`` steps are queued beyond
    the flags seen); the output is identical to the full loop's. ``generate.decode_steps``
    counts the decode steps launched (``generate_beam``'s too).

    Each decode step is one function of fixed tensors that takes its step
    index from the device (``_decode_step``), the counterpart of the JAX
    package's compiled ``scan``/``while_loop``. On the card it is captured
    once into a CUDA graph and replayed for every step: the captures are
    kept per model (``_decode_graphs``, at most two), keyed on the batch,
    the prompt and output lengths, the decoder's config, the knobs and
    the address of every decoder tensor (``layers.tree_addresses``), so a
    replaced weight is captured anew; ``generate.captures`` counts the captures. The first capture
    synchronizes the card; a capture that fails raises. ``cuda_graph=False``
    runs the same step eagerly on the card; on the CPU and under tensor
    parallelism it always runs eagerly."""
    if tensor_parallel() is not None:
        early_exit = False  # every rank of the model group launches every step
    device = batch["input_ids"].device
    if do_sample and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    knobs = _Knobs(int(eos_token_id), int(pad_token_id), bool(do_sample), float(temperature),
                   float(top_p), int(min_length), float(repetition_penalty))
    with torch.no_grad():
        dec = _Decode(params, cfg, batch, max_new_tokens, knobs, generator, clock, cuda_graph)
        with stage(clock, "decode"):
            flags = _DoneFlags(max_new_tokens, device) if early_exit else None
            steps = 0
            while steps < max_new_tokens - 1:
                if flags is not None and flags.seen_all_done():
                    break  # the columns left hold pad already
                dec.step()
                steps += 1
                if flags is not None:
                    flags.record(dec.st.done)
            return dec.finish(steps)


generate.decode_steps = 0
generate.captures = 0


def stream_greedy(params, cfg: MiniGPT4Config, batch, max_new_tokens: int, eos_token_id: int,
                  pad_token_id: int = 0, *, cuda_graph: bool = True) -> Iterator[int]:
    """The greedy tokens of a one-row ``batch``, one at a time: the first
    after the prefill, each later one after one more decode step, launched
    only when the consumer asks for it (at most ``max_new_tokens``; EOS
    repeats once the row is done). The same step as ``generate``'s, with
    the same captures; each token is one host read. While the stream is
    open its state is in use: a decode of the same shape in between takes
    a state of its own (and a capture of its own) and leaves the stream's
    alone."""
    knobs = _Knobs(int(eos_token_id), int(pad_token_id), False, 1.0, 0.9, 1, 1.0)
    with torch.no_grad():
        dec = _Decode(params, cfg, batch, max_new_tokens, knobs, None, None, cuda_graph)
    dec.st.in_use = True
    try:
        for t in range(max_new_tokens):
            if t:
                with torch.no_grad():
                    dec.step()
            yield int(dec.st.token[0])
    finally:
        dec.st.in_use = False


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
    Each step adds one to ``generate.decode_steps``. Returns [B,
    max_new_tokens] token ids of each row's best beam."""
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
        generate.decode_steps += 1
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
