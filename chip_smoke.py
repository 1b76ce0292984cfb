#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``certifiedgpt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. Device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off for float32 matmuls and convolutions.
2. Build: compiles the CUDA kernels from ``certifiedgpt_tpu_torch/csrc/``
   (``nvcc``, sm_90a) and prints the build seconds and ptxas' summary
   (registers, spills, shared memory, performance warnings).
3. Kernels: calls each of the six kernels' wrappers at the main path's
   shapes, holds the result against its plain PyTorch version on the same
   card, and times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (CUDA events): the cls-split kernel
   (one launch: the patch rows and the cls row, the latter also against its
   own plain version); the LN + row-quant and GELU + row-quant kernels at
   the patch and cls streams' row counts (98304 and 96) and at 1 and 4097
   rows and at the eval and train batches' patch and cls streams (8192 and
   8, 49152 and 48 rows),
   each input with a row of zeros, timed on N(0, 1) and N(0, 3^2)
   rows; the flash kernel at
   [96, 1025, 16, 88] in both layouts and causal at [4, 333, 16, 88]; the
   explicit-scale cls-split form at [96, 16, 1025, 88]; the noise kernel at
   96 copies of a 448x448x3 image. Tolerances: int8 codes one step apart on
   at most 1e-4 of the elements and row scales within 1e-6 relative against
   the plain versions that repeat the kernels' arithmetic (the LayerNorm's;
   the GELU's with the A-S erf), one step on 1e-3 and 1e-2 against the
   exact-erf GELU; attention
   within atol 2e-2 (bf16) and 1e-2 relative (Frobenius); noise: values
   within 1e-5 of the plain version on the same seed words at the main
   shape and at odd sizes down to one element, moments of (out - x) / sigma
   within 0.01 of 0 and 1, sigma = 0 exact; the noise kernel's SASS
   instructions an element and their time at the issue rate are printed.
4. Main path: builds MiniGPT-4 at full width (EVA ViT-g/14 at 448 px with 39
   layers, the 12-layer Q-Former, a 32-layer 4096-wide Vicuna-7B-shaped
   decoder) through ``MiniGPT4Model.from_config`` from the model block of
   ``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` (int8 ViT and
   decoder kernels, W8A8 activations, int8 KV cache, cls-split attention)
   with seeded synthetic weights, and certifies one seeded synthetic
   448x448 image with n0 = 100, n = 1000, sigma = 0.5, mc_batch = 96, early
   exit, through ``agents.certify.certify_item`` with one chunk in flight
   (its per-stage clock synchronizes at every stage), after one warm-up
   certification of a single chunk each way. The kernels' launch counters
   are reset just before and read just after; each kernel of the path must
   have launched its launches per chunk times the chunks run, every other
   kernel never, and the plain cls query row not once (the cls-split kernel
   computes that row in its one launch). Prints per-stage seconds, peak
   device memory and the
   certify row, and checks the row. Then times one decode step against
   converting the int8 decoder weights to bf16, the host's launch of one
   step from an idle card and behind a spin that holds the card (does the
   step fill the launch queue?), and checks the outputs: the
   ViT through the kernels against the ViT through their plain versions on
   8 images (a cls stream below the 17 rows ``torch._int_mm`` takes), finite
   projected image tokens, greedy tokens in range.
5. Profile: the warm-up's certification (one chunk each way) once more
   without and once under ``torch.profiler``; prints the device time summed
   by kernel group and the top kernels against the call's wall time, and the
   row-quant kernels' device time per call at the patch and the cls rows.
6. Attention forms: the same parameters under ``vit_attn_impl`` flash_custom
   and flash (configs parsed from the model block with the form changed).
   Their ViT tokens on 8 images agree with the flash_cls tower's within
   5e-2 relative (Frobenius); each of the three forms certifies the image
   over two chunks (n0 = n = 96) after a warm-up, with per-stage seconds
   and launch counts (flash_custom and flash: the flash kernel and the
   GELU kernel once a layer per chunk, no other kernel).
7. Entries: the noise kernel mode of ``noisy_tile`` and
   ``cls_split_attention_scaled``, which no certify path calls, each driven
   once through its entry point at the shapes above, launches counted.
9.1-9.2. Look-ahead and early exit, on phase 4's model (run before phase
   8, which builds its own): ``certify_item`` with no clock at (window,
   early exit) (1, off), (4, off), (1, on), (4, on), (1, off) over four
   chunks (n0 = 96, n = 288, the shipped knobs otherwise), printing the
   wall and the decode steps launched a chunk and the peak memory; every
   draw's label and every row must be identical across the runs, and
   window 4's peak within phase 4's plus three noisy-image buffers. Then
   one chunk of the serial and one of the mixed pipeline dispatched, from
   the noise draw to the event behind the tokens' copy, under
   ``torch.cuda.set_sync_debug_mode("error")``: a host sync fails. Then
   the early exit firing: a tiny model whose weights chain each row's
   prompt to EOS at a different step decodes with the exit off and on under
   the same mode; the tokens must agree, and the exit must launch at least
   the steps until the last EOS and fewer than the full loop's.
8. Launcher: ``certifiedgpt_tpu_torch.launch.main`` runs ``certify`` on
   ``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` and
   ``smoothing_predict`` on ``vqav2_predict_noise_0.5.yaml``, both
   unchanged (full width, seeded synthetic weights, ``dispatch_window``
   4 by default), over a written
   VQAv2-shaped set of two 640x480 JPEGs, with ``vqa_finetuned`` pointing at
   a written ``llama_proj`` checkpoint in the JAX package's ``.npz`` format
   (the environment variables the YAMLs read point at these files; the
   checkpoint paths of the model block at paths that do not exist). Checks
   the rows and summaries against the JAX package's keys, that every
   ``encode_img`` call read the checkpoint's projection bit for bit, and
   that each path kernel launched its launches per chunk (as in phase 4)
   times the chunks dispatched (an early stop leaves up to the window's
   chunks in flight); prints the model build seconds, the seconds per
   image, the decode steps launched, the peak memory and the card's name
   and power limit, with the card's SM clock, power draw and temperature
   (``nvidia-smi`` each second) during phase 4's certification and each
   launcher run.
9.3. Continuous: ``launch.main`` runs ``certify`` on
   ``vqav2_certify_continuous.yaml`` unchanged (8 image slots, window 4)
   over 3 written images: 3 rows with the JAX package's continuous keys,
   each OTHER at phase 8's radius after all 1100 draws, a summary with
   ``continuous`` and ``images_per_hour``, ceil(3 x 1100 / 96) = 35 chunks
   dispatched with the path's launches each; prints seconds per image
   beside phase 8's serial figure, and the peak memory.
10. Eval: ``launch.main`` runs ``eval`` on
   ``configs/eval_configs/vqav2_eval_noise_0.5.yaml`` unchanged (batch 8,
   seq_len 320, early exit, window 2) over 10 written questions, two
   batches (the second padded from 2 rows): ``eval_results.json`` has the
   JAX package's summary keys and 10 predictions, each batch ran the
   path's launches; prints samples per second and the peak memory.

11. Training, with autograd on, over a written VQAv2-shaped set (96 train
   and 48 val 640x480 JPEGs; the model block's checkpoint paths where
   nothing exists). 11.1: on one full-width batch of
   ``configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml`` (48
   images packed 3 to a row, 16 rows x 256 tokens) the loss and the
   ``llama_proj`` gradient through the kernels against the same through
   their plain versions (limits ``TRAIN_LOSS_REL_LIMIT``,
   ``TRAIN_GRAD_REL_LIMIT``, and ``WEIGHT_ONLY_GRAD_REL_LIMIT`` with the
   decoder's activation quant off), with a control (the plain image tokens
   changed at random by as much); one decoder layer's straight-through
   backward against the layer with dequantized bf16 kernels; a batch whose
   last packed row is all padding gives finite values. 11.2:
   ``launch.main(["train", ...])`` on that YAML and on
   ``vqav2_finetuning_noise_0.5.yaml`` (bf16 towers), each a copy with only
   ``max_epoch`` cut to ``TRAIN_EPOCHS``: every train step and val batch
   timed (synchronized) with its kernel launches (39 / 156 / 78 at W8A8, 39
   cls-split with the bf16 towers), finite losses, the checkpoints (the
   resume one with optimizer state), ``loss_history.json`` and the metric
   rows; prints seconds a step, samples and decoder tokens a second and
   the peak memory. 11.3: the predict YAML on phase 8's two images with
   ``vqa_finetuned`` the W8A8 run's ``_best`` checkpoint: every
   ``encode_img`` call reads the trained projection.
12. Checkpoints: 12.1 writes the four checkpoint files at full width from a
   seeded generator on the card, in the upstream formats, under a temporary
   directory (removed at the phase's end; the free disk space is printed
   first and must hold them): a Vicuna HF directory (``config.json``, two
   bf16 safetensors shards and ``model.safetensors.index.json``, written by
   ``write_safetensors``, and a BPE tokenizer trained here with its
   vocabulary padded to 32000 ids where ``transformers`` and ``tokenizers``
   import), ``eva_vit_g.pth`` (f16, BEiT naming, the position table at the
   224-px grid of 257 entries), the BLIP-2 ``.pth`` (``Qformer.bert.*``
   with the text branch, a root ``query_tokens``, keys of other modules)
   and the stage-2 ``.pth``. 12.2: ``launch.main`` certifies one written
   image with ``vqav2_certify_noise_0.5.yaml`` unchanged, ``VICUNA_7B``,
   ``EVA_VIT_G``, ``QFORMER_CKPT``, ``MINIGPT4_STAGE2`` at the files and
   ``VQA_FINETUNED`` empty; prints the seconds to write and to load each
   file, the model build, the peak device memory and host RSS of the load,
   the row and its launches a chunk; checks the first and last layer of
   every stack and the other sampled leaves against the written tensors
   transposed and cast (int8 stacks: ``quantize_kernel`` of them) bit for
   bit, that the row certifies, that every ``encode_img`` read the stage-2
   ``llama_proj``, and the path's launches per chunk.
13. Decode modes: ``launch.main`` runs ``vqav2_eval_noise_0.5.yaml`` on
   phase 10's ten questions with only its run block changed, once with
   ``num_beams: 3``, once sampling (``top_p`` 0.9), once with
   ``repetition_penalty`` 1.2 and ``min_length`` 2 (seconds, launches, peak
   memory, the JAX package's keys); then, on the full-width model,
   ``generate_beam`` at one beam gives greedy's tokens and sampling repeats
   with its seed and differs across seeds, and on phase 9.2's chain model
   ``min_length`` holds EOS back and ``generate`` with every knob and the
   early exit on is dispatched under ``set_sync_debug_mode("error")``.

14. Attack: 14.1 the three kernels of a victim caption at batch 1 against
   their plain versions within phase 3's limits (cls-split attention at
   [1, 16, 1024, 88] with its cls row, LN- and GELU-quant at 1024 and 1
   rows), their times and bounds at those shapes; 14.2 the five surrogates
   of ``configs/attack_configs/vqav2_attack.yaml`` (RN50, RN101, ViT-B/16,
   B/32, L/14) at full width, seeded on the card: one image's embedding
   and the loss gradient's signs against the CPU's, milliseconds a PGD step
   (forward + backward) on one image and on four, the resize's share, and
   the peak memory; 14.3 ``launch.main`` in
   ``attack`` mode on that YAML unchanged over two written images (100 PGD
   steps for each backbone, four sigmas, the full-width W8A8 victim from its
   seed) with ``CLIP_HF_DIR``/``CLIP_VIT_B32`` at a written full-width
   ViT-B/32 HF directory (``model.safetensors``, ``config.json``, a
   synthesized CLIP tokenizer) and ``CLIP_RN50`` at a written OpenAI-layout
   ``RN50.pt``: 40 rows within the 8/255 budget, the success-rate grid and
   the ANCOVA, loaded leaves equal to the written tensors, the CLIP text
   scorer, 39 / 156 / 78 launches a caption, every caption's projection the
   written checkpoint's; seconds per attacked image split into each
   backbone's PGD and the captions; then one caption through the kernels
   against their plain versions (image tokens within the attention's limit,
   the first step's logits against a control); 14.4 the RGF query stage
   (vit_b32, sigma 0.5, 2 queries, 1 iteration) over one image: its
   caption streams and launches.

Prints one JSON line ``{"kernels": [...]}`` with every kernel's numbers (the
attention kernels' achieved TFLOP/s among them; ``attack_batch1``: phase
14.1's; ``cli_launches``: the launches in each launcher run of phases 8-14),
and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels`` stops after phase 3 (for work on one
kernel) and prints the kernel records instead of the two closing lines.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer operations: 64 INT32 lanes per SM (Hopper white paper),
# one operation each, against the 128 FP32 lanes that the f32 peak counts
# at two FLOPs per fused multiply-add
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4

# f32 operations per element counted for the row-quant bounds (LayerNorm:
# two reductions, centre, scale, affine, round, absmax, scale, rint, pack;
# GELU: ~15 for the A-S erf plus the same quantization tail)
LN_QUANT_OPS_PER_ELEM = 12
GELU_QUANT_OPS_PER_ELEM = 25
# special-function units (log2, sqrt, cos): 16 an SM, one result a clock
# each, against the 128 FP32 lanes that the f32 peak counts at two FLOPs
PEAK_MUFU_OPS = PEAK_F32_FLOPS / 16

# the noise kernel per element. Integers: the counter is (image, pair, 0, 0),
# so Philox's rounds 1-2 and one product of round 3 depend on the image or
# the pair alone, once per launch each; a (pair, image) needs round 2's xor,
# round 3's product and two xors, and two products and two three-input xors
# in each of rounds 4-10, where one IMAD.WIDE.U32 gives both words of a
# product: 32 a pair of elements; each uniform is one shift-and-or (LEA.HI).
# f32: 1 - f1, the series near 1 (3), 2 - f1 and the log's scale, the select
# (2), f2 - 3/2 and its two scalings, r * c and x + sigma * g; special
# functions: lg2, sqrt and cos on their units
NOISE_INT_OPS_PER_ELEM = (1 + 3 + 7 * 4) / 2 + 2
NOISE_F32_OPS_PER_ELEM = 13
NOISE_MUFU_OPS_PER_ELEM = 3
# odd image sizes (elements) and copies, down to one element
NOISE_ODD_CASES = (((1,), 1), ((7,), 3), ((3, 3, 1), 3), ((5, 3, 3), 96), ((4097,), 96))

# main-path shapes at mc_batch 96 (EVA ViT-g/14 at 448 px)
MC_BATCH = 96
# batch_size of configs/eval_configs/vqav2_eval_noise_0.5.yaml
EVAL_BATCH = 8
# batch_size of the VQAv2 finetuning configs (configs/train_configs/)
TRAIN_BATCH = 48
VIT_TOKENS = 1024
VIT_SEQ = VIT_TOKENS + 1
VIT_WIDTH = 1408
VIT_HEADS = 16
VIT_HEAD_DIM = VIT_WIDTH // VIT_HEADS
VIT_MLP = 6144
VIT_DEPTH = 39
IMAGE_HWC = (448, 448, 3)
# the causal case of the flash kernel (the decoder-prefill form, in tests)
CAUSAL_SHAPE = (4, 333, VIT_HEADS, VIT_HEAD_DIM)

# model block of configs/certify_configs/vqav2_certify_noise_0.5.yaml; its
# checkpoint paths are left out: the weights are seeded synthetic ones
CERTIFY_MODEL_BLOCK = {
    "arch": "minigpt4",
    "vit_attn_impl": "flash_cls",
    "quantize_llama": True,
    "quantize_vit": True,
    "act_quant": True,
    "kv_quant": True,
    "model_size": "full",
    "image_size": 448,
    "num_query_token": 32,
}
# the ViT's attention forms that the flash kernel serves, beside flash_cls
FLASH_FORMS = ("flash_custom", "flash")

RUN_CFG = {  # run block of configs/certify_configs/vqav2_certify_noise_0.5.yaml
    "noise_level": 0.5,
    "certify_n0": 100,
    "certify_n": 1000,
    "certify_alpha": 0.001,
    "mc_batch": MC_BATCH,
    "max_new_tokens": 10,
    "early_exit": True,
    "early_abstain": True,
    "early_stop_radius": 1.0,
    "seq_len": 96,
    "seed": 42,
}
# phase 4 reads per-stage seconds with a clock that synchronizes the card at
# every stage: one chunk in flight
CLOCKED_RUN_CFG = dict(RUN_CFG, dispatch_window=1)
# one chunk for selection and one for estimation: warm-up and profile
TWO_CHUNK_RUN_CFG = dict(RUN_CFG, certify_n0=MC_BATCH, certify_n=MC_BATCH,
                         early_abstain=False, early_stop_radius=None)
# phase 9.1: the shipped knobs with a budget of four chunks (one selection,
# three estimation: at n = 288 no early stop can fire on these draws)
LOOKAHEAD_RUN_CFG = dict(RUN_CFG, certify_n0=MC_BATCH, certify_n=3 * MC_BATCH)
# (dispatch_window, early_exit) of phase 9.1's runs, in their order; the
# last repeats the first to show drift
LOOKAHEAD_RUNS = ((1, False), (4, False), (1, True), (4, True), (1, False))
# phase 9.2's early exit that fires: a tiny model whose decoder sends each
# prompt's last token along its chain to EOS (2), as in
# tests/test_torch_generate_gpu.py: (last prompt token, the tokens after it)
EXIT_CHAINS = ((20, ()), (10, (11, 12)), (30, (31, 32, 33, 34)), (40, (41,)))
EXIT_STEPS = 24
EXIT_ROWS = (0, 1, 2, 3, 1)  # the chain of each row of the batch
# phase 4: the card is held by a spin of this length while the host launches
# one decode step, to see whether the step's launches fill the launch queue
SPIN_MS = 500.0
QUESTION = "<Img><ImageHere></Img> [vqa] Based on the image, what animal is this?"
GT_ANSWERS = ["cat", "cat", "cat", "dog", "cat", "cat", "kitten", "cat", "cat", "cat"]

# kernel-name substrings of each profile group, first match wins
PROFILE_GROUPS = (
    ("attention kernel", ("attention_kernel",)),
    ("row-quant kernels", ("ln_quant_kernel", "gelu_quant_kernel")),
    ("GEMMs (int8, bf16, f32)", ("gemm", "nvjet", "gemv", "cutlass", "sm90_xmma", "ampere")),
    ("reductions", ("reduce_kernel",)),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw and temperature about once a
    second while the ``with`` block runs, from a thread that the block's end
    stops and joins."""

    QUERY = "--query-gpu=clocks.sm,power.draw,temperature.gpu"

    def __enter__(self):
        import threading

        self.samples = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.stop.wait(1.0):
            out = subprocess.run(["nvidia-smi", self.QUERY, "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout
            try:
                self.samples.append([float(v) for v in out.splitlines()[0].split(",")])
            except (IndexError, ValueError):
                pass  # a read the card did not answer: no sample

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)

    def summary(self) -> str:
        if not self.samples:
            return "no nvidia-smi samples"
        clock, power, temp = zip(*self.samples)
        return (f"SM clock mean {sum(clock) / len(clock):.0f} MHz (min {min(clock):.0f}), "
                f"power draw mean {sum(power) / len(power):.1f} W, temperature max "
                f"{max(temp):.0f} C over {len(clock)} samples")


def bound_ms(bytes_moved: float, ops: float, peak_ops: float, *more_ops):
    """The larger of the bytes' time and each operation type's time
    (``more_ops``: further (ops, peak) pairs, for a kernel that mixes
    types on separate units)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(o / p * 1e3 for o, p in ((ops, peak_ops), *more_ops))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 1 and 2
# ----------------------------------------------------------------------
def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return card


def phase_build():
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    build = cuda_kernels.build()
    log(
        f"[build] {build.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.seconds:.2f} s)"
    )
    for line in build.log.splitlines():
        if line.startswith("==") or any(w in line for w in ("Used", "spill", "arning", "wgmma")):
            log(f"[build] {line.strip()}")


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def compare_codes(torch, a, b):
    """(elements off by one step, their share, the largest step, the largest
    relative scale difference, the largest dequantized difference) of two
    row quantizations (codes, scales)."""
    (qa, sa), (qb, sb) = a, b
    dq = (qa.int() - qb.int()).abs()
    off = int((dq > 0).sum())
    rel = float(((sa - sb).abs() / sb.abs()).max())
    err = float((qa.float() * sa - qb.float() * sb).abs().max())
    return off, off / max(dq.numel(), 1), int(dq.max()), rel, err


def check_row_quant(torch, name, kernel, plains, shapes, ops_per_elem, make_args):
    """Compare an int8 row-quant kernel with its plain versions at each shape
    (row counts of the main path, 1 and 4097; one row of zeros in each input
    of more than one row) on N(0, 3^2) inputs, each plain version with its
    limits ``(plain, max step, max share off, max scale rel)``; time the
    first (the patch stream's) shape on N(0, 1) and N(0, 3^2) inputs, and
    the second (the cls stream's). ``ms`` is the N(0, 1) time: the main
    path's activations are of that size."""
    record = {}
    for m, k in shapes:
        args = make_args(m, k, 3.0)
        if m > 1:
            args[0][m // 2].zero_()
        out = kernel(*args)
        torch.cuda.synchronize()
        for plain, step, share, srel in plains:
            off, frac, worst, rel, err = compare_codes(torch, out, plain(*args))
            log(f"[kernel] {name} [{m}, {k}] vs {plain.__name__}: int8 off-by-one {off}/{m * k} "
                f"({frac:.2e}), max code diff {worst}, scale rel err {rel:.2e}, "
                f"max |dequant diff| {err:.3e}")
            if worst > step or frac > share or not rel <= srel:
                fail(f"{name} disagrees with {plain.__name__} at [{m}, {k}]")
            record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
        if (m, k) == shapes[0]:
            for std in (1.0, 3.0):
                a = args if std == 3.0 else make_args(m, k, std)
                record[f"ms_std{std:g}"] = cuda_ms(torch, lambda: kernel(*a), iters=20)
            record["ms"] = record["ms_std1"]
            record["plain_ms"] = cuda_ms(torch, lambda: plains[0][0](*args), iters=5, warmup=1)
            x = args[0]
            moved = x.numel() * x.element_size() + m * k + 4 * m
            moved += sum(a.numel() * a.element_size() for a in args[1:3] if hasattr(a, "numel"))
            bms, by = bound_ms(moved, ops_per_elem * m * k, PEAK_F32_FLOPS)
            record.update(bound_ms=bms, bound_by=by, library_ms=None)
            log(f"[kernel] {name} [{m}, {k}]: {record['ms_std1']:.4f} ms on N(0,1), "
                f"{record['ms_std3']:.4f} ms on N(0,3^2), plain {record['plain_ms']:.3f} ms, "
                f"bound {bms:.4f} ms ({by})")
        elif (m, k) == shapes[1]:
            record["ms_cls"] = cuda_ms(torch, lambda: kernel(*args), iters=20)
            log(f"[kernel] {name} [{m}, {k}]: {record['ms_cls']:.4f} ms")
        del args, out
        torch.cuda.empty_cache()
    return record


def check_cls_split(torch, device, b=MC_BATCH):
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    h, n, d = VIT_HEADS, VIT_TOKENS, VIT_WIDTH // VIT_HEADS
    g = torch.Generator(device=device).manual_seed(1)
    prem = (d ** -0.5) * FA.CLS_SPLIT_Q_PREMUL_LOG2E
    # operands as the main path makes them: strided views of the fused qkv
    # output [B, S, 3, H, D] (q pre-scaled)
    scale3 = torch.tensor([prem, 1.0, 1.0], device=device)[None, None, :, None, None]

    def qkv(s):
        y = torch.randn((b, s, 3, h, d), generator=g, device=device) * scale3
        y = y.to(torch.bfloat16)
        return [y[:, :, i].transpose(1, 2) for i in range(3)]

    qp, kp, vp = qkv(n)
    qc, kc, vc = qkv(1)
    args = (qp, kp, vp, qc, kc, vc)
    out_c, out_p = FA.cls_split_attention_parts(*args)
    ref_c, ref_p = FA._cls_split_attention_plain(*args)
    row = FA._cls_query_row(qc, kp, vp, kc, vc)  # the plain version of the kernel's cls row
    torch.cuda.synchronize()
    err_c = max(max_err(out_c, ref_c), max_err(out_c, row))
    err = max(max_err(out_p, ref_p), err_c)
    rel = max(rel_err(out_p, ref_p), rel_err(out_c, ref_c), rel_err(out_c, row))
    # both against f32 attention on the same (bf16) inputs, for scale
    ex_c, ex_p = FA._cls_split_attention_plain(*(a.float() for a in args))
    err_k = float((out_p.float() - ex_p).abs().max())
    err_p = float((ref_p.float() - ex_p).abs().max())
    log(
        f"[kernel] cls_split_attention [{b}, {h}, {n}, {d}]: max abs err {err:.3e} "
        f"(the cls row {err_c:.3e}), relative (Frobenius) {rel:.3e} "
        f"(max |out| {float(ex_p.abs().max()):.3f}; vs f32 attention: kernel "
        f"{err_k:.3e}, plain {err_p:.3e})"
    )
    del ex_c, ex_p, row
    if not math.isfinite(err) or err > 2e-2 or not rel < ATTN_REL_LIMIT:
        fail("cls_split_attention disagrees with its plain version")
    # ms: the wrapper's one launch (N patch rows and the cls row); plain_ms and
    # library_ms compute the same N + 1 rows
    ms = cuda_ms(torch, lambda: FA.cls_split_attention_parts(*args), iters=10 if b > 1 else 100)
    plain_ms = cuda_ms(torch, lambda: FA._cls_split_attention_plain(*args), iters=3, warmup=1)
    q = torch.cat([qc, qp], dim=2)
    k = torch.cat([kc, kp], dim=2)
    v = torch.cat([vc, vp], dim=2)
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)),
        iters=10,
    )
    ops = 4.0 * b * h * (n + 1) * (n + 1) * d  # N + 1 query rows over N + 1 keys
    moved = 2.0 * 4 * b * h * (n + 1) * d  # q, k, v with their cls rows, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] cls_split_attention batch {b}: one launch with the cls row {ms:.4f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del args, out_c, out_p, ref_c, ref_p, q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "tflops": tflops}


def fused_bshd(torch, g, device, b, s, h, d):
    """q, k, v as ``[B, S, H, D]`` views of one fused qkv product
    ``[B, S, 3 H D]`` (row stride 3 H D), as the ViT's flash_custom block
    makes them; ``.transpose(1, 2)`` gives the flash block's ``[B, H, S, D]``
    views of the same product."""
    y = torch.randn((b, s, 3 * h * d), generator=g, device=device).to(torch.bfloat16)
    return [t.reshape(b, s, h, d) for t in y.split(h * d, dim=-1)]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """Relative Frobenius error of ``a`` against ``b``: catches a fault of one
    key tile that a max-abs limit, loose against outputs of ~0.05, lets by."""
    return float((a.float() - b.float()).norm() / b.float().norm())


# limit on the relative Frobenius error of the attention kernels against
# their plain versions (bf16 outputs and P: ~4e-3 measured on the H100)
ATTN_REL_LIMIT = 1e-2


def check_flash(torch, device):
    """The flash kernel at the ViT's shape in both layouts (flash_custom's
    [B, S, H, D] views, flash's [B, H, S, D] views) and causal at
    CAUSAL_SHAPE, against the plain version; timed against the plain
    version and ``scaled_dot_product_attention`` on the same views."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    b, s, h, d = MC_BATCH, VIT_SEQ, VIT_HEADS, VIT_HEAD_DIM
    scale = d ** -0.5
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v = fused_bshd(torch, g, device, b, s, h, d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    out = FA.flash_attention(q, k, v)
    out_h = FA.builtin_flash_attention_bhsd(qh, kh, vh, d)
    ref = FA._flash_attention_plain(q, k, v, False, scale)
    torch.cuda.synchronize()
    err = max(max_err(out, ref), max_err(out_h.transpose(1, 2), ref))
    rel = max(rel_err(out, ref), rel_err(out_h.transpose(1, 2), ref))
    exact = FA._flash_attention_plain(q.float(), k.float(), v.float(), False, scale)
    err_k, err_p = max_err(out, exact), max_err(ref, exact)
    log(f"[kernel] flash_attention [{b}, {s}, {h}, {d}]: max abs err {err:.3e}, relative "
        f"(Frobenius) {rel:.3e} over both layouts (max |out| {float(exact.abs().max()):.3f}; "
        f"vs f32 attention: kernel "
        f"{err_k:.3e}, plain {err_p:.3e})")
    del out, out_h, exact
    torch.cuda.empty_cache()

    qc, kc, vc = fused_bshd(torch, g, device, *CAUSAL_SHAPE)
    out_c = FA.flash_attention(qc, kc, vc, causal=True)
    ref_c = FA._flash_attention_plain(qc, kc, vc, True, scale)
    err_c = max_err(out_c, ref_c)
    rel_c = rel_err(out_c, ref_c)
    # the first query sees only the first key
    err_first = max_err(out_c[:, 0], vc[:, 0])
    causal_ms = cuda_ms(torch, lambda: FA.flash_attention(qc, kc, vc, causal=True), iters=20)
    causal_plain_ms = cuda_ms(torch, lambda: FA._flash_attention_plain(qc, kc, vc, True, scale),
                              iters=5, warmup=1)
    log(f"[kernel] flash_attention causal {list(CAUSAL_SHAPE)}: max abs err {err_c:.3e}, "
        f"relative (Frobenius) {rel_c:.3e} (first row vs v[0]: {err_first:.3e}); "
        f"kernel {causal_ms:.3f} ms, "
        f"plain {causal_plain_ms:.3f} ms")
    for name, e in (("flash_attention", err), ("flash_attention causal", err_c),
                    ("flash_attention causal row 0", err_first)):
        if not math.isfinite(e) or e > 2e-2:
            fail(f"{name} disagrees with its plain version ({e:.3e})")
    for name, e in (("flash_attention", rel), ("flash_attention causal", rel_c)):
        if not e < ATTN_REL_LIMIT:
            fail(f"{name} disagrees with its plain version (relative {e:.3e})")

    ms = cuda_ms(torch, lambda: FA.flash_attention(q, k, v), iters=10)
    ms_bhsd = cuda_ms(torch, lambda: FA.builtin_flash_attention_bhsd(qh, kh, vh, d), iters=10)
    plain_ms = cuda_ms(torch, lambda: FA._flash_attention_plain(q, k, v, False, scale),
                       iters=3, warmup=1)
    library_ms = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), iters=10)
    ops = 4.0 * b * h * s * s * d
    moved = 2.0 * 4 * b * s * h * d  # q, k, v, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] flash_attention: kernel {ms:.3f} ms on [B, S, H, D] views (flash_custom, "
        f"{tflops:.1f} TFLOP/s), "
        f"{ms_bhsd:.3f} ms on [B, H, S, D] views (flash), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del q, k, v, qh, kh, vh, ref, qc, kc, vc, out_c, ref_c
    torch.cuda.empty_cache()
    return {"max_abs_err": max(err, err_c), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "ms_bhsd": ms_bhsd, "causal_ms": causal_ms, "tflops": tflops}


def check_cls_split_scaled(torch, device):
    """The explicit-scale cls-split form on ``[B, H, 1025, D]`` tensors with
    cls at index 0 (the patch operands are views one row in)."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    b, h, s, d = MC_BATCH, VIT_HEADS, VIT_SEQ, VIT_HEAD_DIM
    scale = d ** -0.5
    g = torch.Generator(device=device).manual_seed(4)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    out = FA.cls_split_attention_scaled(q, k, v, d)
    ref = FA._cls_split_attention_scaled_plain(q, k, v, scale)
    scale_log2 = scale * FA.CLS_SPLIT_Q_PREMUL_LOG2E
    row = FA._cls_query_row(q[:, :, :1], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1],
                            scale_log2)
    torch.cuda.synchronize()
    err_c = max(max_err(out[:, :, :1], ref[:, :, :1]), max_err(out[:, :, :1], row))
    err = max(max_err(out, ref), err_c)
    rel = max(rel_err(out, ref), rel_err(out[:, :, :1], ref[:, :, :1]),
              rel_err(out[:, :, :1], row))
    log(f"[kernel] cls_split_attention_scaled [{b}, {h}, {s}, {d}]: max abs err {err:.3e} "
        f"(the cls row {err_c:.3e}), relative (Frobenius) {rel:.3e} "
        f"(max |out| {float(ref.float().abs().max()):.3f})")
    if not math.isfinite(err) or err > 2e-2 or not rel < ATTN_REL_LIMIT:
        fail("cls_split_attention_scaled disagrees with its plain version")
    # ms: the wrapper's one launch, all 1 + N rows
    ms = cuda_ms(torch, lambda: FA.cls_split_attention_scaled(q, k, v, d), iters=10)
    plain_ms = cuda_ms(torch, lambda: FA._cls_split_attention_scaled_plain(q, k, v, scale),
                       iters=3, warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                         iters=10)
    ops = 4.0 * b * h * s * s * d  # N + 1 query rows over N + 1 keys
    moved = 2.0 * 4 * b * h * s * d  # q, k, v, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] cls_split_attention_scaled: one launch with the cls row {ms:.3f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"{library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del q, k, v, out, ref, row
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "tflops": tflops}


def check_noise(torch, device):
    """The noise kernel at mc_batch copies of a 448 px image, sigma 0.5, and
    at odd sizes down to one element: its values agree with the plain
    version's on the same seed words within 1e-5 (the plain version's exact
    log, sqrt and cos against the kernel's domain-limited ones; other Philox
    words would give other normals, off by O(sigma)), (out - x) / sigma has
    mean 0 and std 1 within 0.01, and sigma = 0 returns the clean tile bit
    for bit. Also prints the kernel's SASS instructions an element (one trip
    of its image loop) and the time they take at 128 a clock an SM at the
    card's highest SM clock: the issue rate, beside the bound but not one."""
    import sass_count
    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import noise as N

    n, sigma = MC_BATCH, 0.5
    g = torch.Generator(device=device).manual_seed(3)
    sig = torch.tensor(sigma, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    odd_err = 0.0
    for shape, copies in NOISE_ODD_CASES:
        xs = torch.randn(shape, generator=g, device=device)
        out = N.noisy_tile(xs, copies, sigma, gen.manual_seed(8), use_kernel=True)
        ref = N._noisy_tile_kernel_plain(xs, copies, sig, N._seed_words(gen.manual_seed(8), device))
        e = max_err(out, ref)
        if out.shape != ref.shape or not math.isfinite(e) or e > 1e-5:
            fail(f"the noise kernel disagrees with its plain version at {copies} x {list(shape)} "
                 f"({e:.3e})")
        odd_err = max(odd_err, e)
    x = torch.randn(IMAGE_HWC, generator=g, device=device)
    out = N.noisy_tile(x, n, sigma, gen.manual_seed(7), use_kernel=True)
    seed = N._seed_words(gen.manual_seed(7), device)
    ref = N._noisy_tile_kernel_plain(x, n, sig, seed)
    err = max_err(out, ref)
    unequal = int((out != ref).sum())
    resid = (out - x) / sigma
    mean, std = float(resid.mean()), float(resid.std())
    zero_tile = N.noisy_tile(x, n, 0.0, gen, use_kernel=True)
    clean = bool(torch.equal(zero_tile, x.expand_as(zero_tile)))
    log(f"[kernel] noisy_tile kernel [{n}, {', '.join(map(str, IMAGE_HWC))}] sigma {sigma}: "
        f"max abs err against the plain version {err:.3e}, so max |g - g_plain| "
        f"{err / sigma:.3e} ({unequal} of {out.numel()} values not bit-identical); odd sizes "
        f"{', '.join(f'{c} x {list(s)}' for s, c in NOISE_ODD_CASES)}: max abs err "
        f"{odd_err:.3e}; noise mean {mean:.2e}, std {std:.5f}; sigma 0 returns the clean "
        f"tile: {clean}")
    if not math.isfinite(err) or err > 1e-5:
        fail("the noise kernel disagrees with its plain version")
    if abs(mean) > 0.01 or abs(std - 1.0) > 0.01 or not clean:
        fail("the noise kernel's noise is not N(0, sigma^2) or sigma = 0 is not exact")
    del out, ref, resid, zero_tile
    torch.cuda.empty_cache()

    xc = x.contiguous()
    ms = cuda_ms(torch, lambda: N._launch_noise(xc, n, sig, seed), iters=20)
    plain_ms = cuda_ms(torch, lambda: N._noisy_tile_kernel_plain(x, n, sig, seed),
                       iters=3, warmup=1)
    # the live path: torch.randn (Philox in PyTorch's own kernel) + add
    library_ms = cuda_ms(torch, lambda: N.noisy_tile(x, n, sigma, gen), iters=20)
    elems = n * x.numel()
    moved = 4.0 * (x.numel() + elems)
    bms, by = bound_ms(moved, NOISE_INT_OPS_PER_ELEM * elems, PEAK_INT32_OPS,
                       (NOISE_F32_OPS_PER_ELEM * elems, PEAK_F32_FLOPS),
                       (NOISE_MUFU_OPS_PER_ELEM * elems, PEAK_MUFU_OPS))
    trip, per_elem = sass_count.noise_trip(cuda_kernels.build().path)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = sass_count.max_sm_clock_mhz()
    issue_ms = sass_count.issue_ms(per_elem, elems, sms, clock)
    log(f"[kernel] noisy_tile kernel: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"torch.randn + add {library_ms:.3f} ms, bound {bms:.4f} ms ({by}; bytes alone "
        f"{moved / PEAK_BYTES_PER_S * 1e3:.4f} ms, integers "
        f"{NOISE_INT_OPS_PER_ELEM * elems / PEAK_INT32_OPS * 1e3:.4f} ms, special functions "
        f"{NOISE_MUFU_OPS_PER_ELEM * elems / PEAK_MUFU_OPS * 1e3:.4f} ms); SASS "
        f"{per_elem:.2f} instructions an element (one trip of the image loop: "
        f"{json.dumps(trip)}), issue rate {issue_ms:.4f} ms at the highest SM clock "
        f"{clock:.0f} MHz on {sms} SMs (not a bound)")
    return {"max_abs_err": max(err, odd_err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "max_abs_g_err": err / sigma,
            "sass_per_elem": per_elem}


# limits of the row-quant kernels against their plain versions: (largest
# code step, share of elements off, scale relative difference). The kernels
# repeat the plain versions' roundings (the LayerNorm's sums in its order, the
# GELU's A-S erf), so only the approximate reciprocal and exponential of the
# erf move a bf16 rounding, rarely; against the exact erf, one bf16 step
# anywhere in a row may move its scale.
ROW_QUANT_TIGHT = (1, 1e-4, 1e-6)
ROW_QUANT_EXACT_ERF = (1, 1e-3, 1e-2)


def row_quant_args(torch, device, seed: int):
    """Makers of the row-quant kernels' arguments ``(m, k, std)``: bf16
    N(0, std^2) rows, and the LayerNorm's scale and bias."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=device) * std).to(torch.bfloat16)

    def ln_args(m, k, std):
        scale = (1.0 + 0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        return [normal((m, k), std), scale, bias, 1e-6]

    def gelu_args(m, k, std):
        return [normal((m, k), std)]

    return ln_args, gelu_args


def phase_kernels(torch, device):
    from certifiedgpt_tpu_torch.ops import quantization as Q

    rows = MC_BATCH * VIT_TOKENS
    # patch and cls streams first, then odd counts, eval's two streams and a
    # training batch's two
    row_counts = (rows, MC_BATCH, 1, 4097, EVAL_BATCH * VIT_TOKENS, EVAL_BATCH,
                  TRAIN_BATCH * VIT_TOKENS, TRAIN_BATCH)
    ln_args, gelu_args = row_quant_args(torch, device, 0)

    records = {}
    records["cls_split_attention"] = check_cls_split(torch, device)
    records["ln_quant_rows"] = check_row_quant(
        torch, "ln_quant_rows", Q.ln_quant_rows,
        [(Q._ln_quant_rows_plain, *ROW_QUANT_TIGHT)],
        [(m, VIT_WIDTH) for m in row_counts], LN_QUANT_OPS_PER_ELEM, ln_args,
    )
    records["gelu_quant_rows"] = check_row_quant(
        torch, "gelu_quant_rows", Q.gelu_quant_rows,
        [(Q._gelu_quant_rows_as_plain, *ROW_QUANT_TIGHT),
         (Q._gelu_quant_rows_plain, *ROW_QUANT_EXACT_ERF)],
        [(m, VIT_MLP) for m in row_counts], GELU_QUANT_OPS_PER_ELEM, gelu_args,
    )
    records["flash_attention"] = check_flash(torch, device)
    records["cls_split_attention_scaled"] = check_cls_split_scaled(torch, device)
    records["noisy_tile_kernel"] = check_noise(torch, device)
    return records


KERNELS = [
    # name, source, TPU kernel replaced, the path whose run gives its launches
    ("cls_split_attention", "certifiedgpt_tpu_torch/csrc/cls_split_attention.cu",
     "certifiedgpt_tpu/ops/flash_attention.py:258", "certify flash_cls"),
    ("ln_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:208", "certify flash_cls"),
    ("gelu_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:136", "certify flash_cls"),
    ("flash_attention", "certifiedgpt_tpu_torch/csrc/flash_attention.cu",
     "certifiedgpt_tpu/ops/flash_attention.py:39", "certify flash_custom"),
    ("noisy_tile_kernel", "certifiedgpt_tpu_torch/csrc/noise.cu",
     "certifiedgpt_tpu/ops/noise.py:58", "noisy_tile kernel mode"),
    ("cls_split_attention_scaled", "certifiedgpt_tpu_torch/csrc/cls_split_attention.cu",
     "scripts/bench_cls_split_attention.py:35", "cls_split_attention_scaled"),
]

# launches per certify chunk of each kernel under each ViT attention form:
# the split-stream tower runs the cls-split kernel once a layer and the two
# row-quant kernels on both streams (LN at the qkv and fc1 inputs, GELU at
# fc2); the flash block runs the flash kernel once a layer and the GELU
# kernel at fc2 on its one stream, and quantizes its qkv and fc1 inputs in
# plain PyTorch as the JAX package's block does
PER_CHUNK = {
    "flash_cls": {"cls_split_attention": VIT_DEPTH, "ln_quant_rows": 4 * VIT_DEPTH,
                  "gelu_quant_rows": 2 * VIT_DEPTH, "flash_attention": 0},
    "flash_custom": {"cls_split_attention": 0, "ln_quant_rows": 0,
                     "gelu_quant_rows": VIT_DEPTH, "flash_attention": VIT_DEPTH},
}
PER_CHUNK["flash"] = PER_CHUNK["flash_custom"]


def wrappers():
    """Each kernel's wrapper, which carries its launch counter."""
    from certifiedgpt_tpu_torch.ops.flash_attention import (
        cls_split_attention_parts,
        cls_split_attention_scaled,
        flash_attention,
    )
    from certifiedgpt_tpu_torch.ops.noise import noisy_tile
    from certifiedgpt_tpu_torch.ops.quantization import gelu_quant_rows, ln_quant_rows

    return {"cls_split_attention": cls_split_attention_parts,
            "ln_quant_rows": ln_quant_rows, "gelu_quant_rows": gelu_quant_rows,
            "flash_attention": flash_attention, "noisy_tile_kernel": noisy_tile,
            "cls_split_attention_scaled": cls_split_attention_scaled}


def reset_counts():
    from certifiedgpt_tpu_torch.ops.flash_attention import _cls_query_row

    for fn in wrappers().values():
        fn.launches = 0
    _cls_query_row.calls = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def check_counts(label, launches, per_chunk, chunks):
    """Every kernel of the path launched ``per_chunk`` times a chunk, and
    no other kernel at all; the plain cls query row (the cls-split kernel
    computes that row itself) was never called."""
    from certifiedgpt_tpu_torch.ops.flash_attention import _cls_query_row

    if _cls_query_row.calls:
        fail(f"{label}: the plain cls query row ran {_cls_query_row.calls} times")
    for name, n in launches.items():
        want = per_chunk.get(name, 0) * chunks
        if n != want:
            fail(f"{label}: kernel {name} launched {n} times, expected {want} "
                 f"({per_chunk.get(name, 0)} x {chunks} chunks)")
        if per_chunk.get(name, 0) and n <= 0:
            fail(f"{label}: kernel {name} was not launched")


# ----------------------------------------------------------------------
# phase 4: the main path
# ----------------------------------------------------------------------
def phase_main_path(torch, device):
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    t0 = time.perf_counter()
    model = MiniGPT4Model.from_config(CERTIFY_MODEL_BLOCK, device)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(
        f"[main] built full-width model (ViT depth {cfg.vit.depth}, attn_impl "
        f"{cfg.vit.attn_impl}, Q-Former {cfg.qformer.num_layers} layers, decoder "
        f"{cfg.llama.num_layers}x{cfg.llama.hidden_size}) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card"
    )
    image = np.random.RandomState(0).randn(*IMAGE_HWC).astype(np.float32)

    # warm-up chunk: allocator and cuBLAS heuristics, outside the counted run
    clock = StageClock(device)
    certify_item(model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with CardSampler() as card_state:
        t0 = time.perf_counter()
        row = certify_item(model, image, QUESTION, GT_ANSWERS, CLOCKED_RUN_CFG, index=0,
                           clock=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    chunks = clock.counts.get("noise", 0)
    stages = stage_seconds(clock, wall)
    log(f"[main] certify row: {json.dumps(row)}")
    log(f"[main] wall {wall:.3f} s over {chunks} chunks of {MC_BATCH}; stage seconds {json.dumps(stages)}")
    log(f"[main] decode steps {clock.counts.get('decode_step', 0)}; peak memory {peak_gb:.2f} GB; "
        f"card during the run: {card_state.summary()}")
    log(f"[main] launches {json.dumps(launches)}")
    check_counts("certify flash_cls", launches, PER_CHUNK["flash_cls"], chunks)
    check_row(row, CLOCKED_RUN_CFG)
    decode_costs(torch, model, device)
    check_outputs(torch, model, device)
    phase_profile(torch, model, image)
    return model, image, launches, {"wall_seconds": wall, "stage_seconds": stages,
                                    "chunks": chunks, "peak_gb": peak_gb, "row": row}


def stage_seconds(clock, wall):
    stages = {k: round(v, 4) for k, v in clock.seconds.items()}
    stages["other_host"] = round(wall - sum(clock.seconds.values()), 4)
    return stages


def check_row(row, run_cfg):
    required = {"index", "question_id", "label", "answer", "radius", "correct",
                "abstain", "seconds", "sigma", "n0", "n", "draws"}
    if set(row) != required:
        fail(f"certify row keys {sorted(row)} != {sorted(required)}")
    if not (isinstance(row["label"], int) and math.isfinite(row["radius"]) and row["radius"] >= 0):
        fail(f"malformed certify row {row}")
    budget = run_cfg["certify_n0"] + run_cfg["certify_n"]
    if row["abstain"] != (row["label"] == -1) or not 0 < row["draws"] <= budget:
        fail(f"inconsistent certify row {row}")


def decode_costs(torch, model, device):
    """What the plain decode path costs per step: the time to convert every
    int8 decoder kernel to bf16 (the weight-only matmuls do this each step)
    against one whole decode step at the certify batch; and whether the
    host or the card sets a step's pace: the host's seconds to launch one
    step (from an idle card, not waiting for it), and the same step
    replayed from a CUDA graph (the card's time without the host's
    launches); and the host's seconds to launch the step behind a spin that
    holds the card for ``SPIN_MS``: near the spin's length if the step's
    launches fill the launch queue (the host then waits for the card), near
    the idle card's figure if they do not (the time is the host's own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from certifiedgpt_tpu_torch.models.llama import init_kv_cache, llama_apply

    params = model.params["llama"]
    cfg = model.cfg.llama
    mods = [m for m, leaves in params["layers"].items() if "kernel_q" in leaves]

    def dequant_all():
        for m in mods:
            kq = params["layers"][m]["kernel_q"]
            for layer in range(kq.shape[0]):
                kq[layer].to(torch.bfloat16)

    total = RUN_CFG["seq_len"] + RUN_CFG["max_new_tokens"]
    cache = init_kv_cache(cfg, MC_BATCH, total, device)
    mask = torch.ones((MC_BATCH, total), dtype=torch.int32, device=device)
    x = torch.zeros((MC_BATCH, 1, cfg.hidden_size), dtype=torch.bfloat16, device=device)
    pos = torch.full((MC_BATCH, 1), RUN_CFG["seq_len"], dtype=torch.int32, device=device)

    def step():
        llama_apply(params, cfg, x, mask, pos, cache, RUN_CFG["seq_len"])

    conv_ms = cuda_ms(torch, dequant_all, iters=3, warmup=1)
    step_ms = cuda_ms(torch, step, iters=3, warmup=1)
    wbytes = sum(params["layers"][m]["kernel_q"].numel() for m in mods)
    log(
        f"[main] decode step {step_ms:.2f} ms at batch {MC_BATCH}; converting the "
        f"{wbytes / 1e9:.2f} G int8 decoder weights to bf16 alone takes {conv_ms:.2f} ms "
        f"(bound for reading them once as int8: {wbytes / PEAK_BYTES_PER_S * 1e3:.2f} ms)"
    )
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    # the same launch behind a spin that holds the card: a step whose
    # launches overflow the launch queue makes the host wait for the spin
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    spin_cycles = int(10 ** 8 * SPIN_MS / start.elapsed_time(end))
    behind_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        step()
        behind_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device_ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        step()
    graph_ms = cuda_ms(torch, graph.replay, iters=5, warmup=1)
    del graph
    log(
        f"[main] decode step: the host launches it in {min(host_ms):.2f} ms (of 3: "
        f"{', '.join(f'{t:.2f}' for t in host_ms)}), the card runs it from a CUDA graph in "
        f"{graph_ms:.2f} ms, eager {step_ms:.2f} ms"
    )
    verdict = ("the launch queue filled: the host waited for the card"
               if min(behind_ms) > SPIN_MS / 2 else
               "the queue never filled: the launch time is the host's own")
    log(
        f"[main] decode step behind a {SPIN_MS:.0f} ms spin of the card: the host launches it "
        f"in {min(behind_ms):.2f} ms (of 3: {', '.join(f'{t:.2f}' for t in behind_ms)}), "
        f"from an idle card {min(host_ms):.2f} ms; {device_ops} device operations a step; "
        f"{verdict}"
    )


def check_outputs(torch, model, device):
    """Correctness of the full-width outputs on the card: the projected
    image tokens are finite and of the expected shape, and the whole tower
    run through the kernels agrees with the same tower run through the
    kernels' plain versions (which the CPU tests hold against the JAX
    package) on a few images. Greedy tokens are in the vocabulary."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.models import eva_vit as V
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops import quantization as Q

    cfg = model.cfg
    params = model.params
    rng = np.random.RandomState(1)
    # 8 images: the cls stream's W8A8 products take the padded _int_mm path
    num = 8
    images = torch.from_numpy(rng.randn(num, 448, 448, 3).astype(np.float32)).to(device)
    feats = M.eva_vit_apply(params["vit"], cfg.vit, images)
    with mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain), \
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain), \
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_plain):
        feats_plain = M.eva_vit_apply(params["vit"], cfg.vit, images)
    rel = float((feats.float() - feats_plain.float()).norm() / feats_plain.float().norm())
    log(f"[check] ViT tokens {tuple(feats.shape)}, kernels vs plain versions on {num} images: "
        f"relative error {rel:.3e}")
    if tuple(feats.shape) != (num, cfg.vit.seq_len, cfg.vit.embed_dim) or not (rel < 5e-2):
        fail("the ViT through the kernels disagrees with its plain path")
    out = M.encode_img(params, cfg, images)
    expected = (num, cfg.num_img_tokens, cfg.llama.hidden_size)
    if tuple(out.shape) != expected or not bool(torch.isfinite(out).all()):
        fail(f"encode_img output {tuple(out.shape)} is not finite or not {expected}")
    prompt = {k: torch.zeros((num, 40), dtype=torch.long, device=device)
              for k in ("input_ids", "attention_mask")}
    prompt["attention_mask"] += 1
    prompt["img_pos"] = torch.full((num,), 1, dtype=torch.long, device=device)
    tokens = M.generate_greedy(params, cfg, dict(prompt, image=images), 4,
                               model.tokenizer.eos_token_id)
    if tokens.shape != (num, 4) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llama.vocab_size:
        fail(f"greedy tokens out of range: {tokens.tolist()}")
    log(f"[check] encode_img {tuple(out.shape)} finite; greedy tokens {tokens[:2].tolist()} ...")


def phase_profile(torch, model, image):
    """The warm-up's certification (one chunk each way) timed once more
    unprofiled, then once under ``torch.profiler``: device time summed by
    kernel group and the top kernels, each as a share of the profiled wall.
    The share of the summed kernel time in the wall is the device's busy
    share (kernels run one at a time on the one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from certifiedgpt_tpu_torch.agents.certify import certify_item

    def run():
        t0 = time.perf_counter()
        certify_item(model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"[profile] two chunks of {MC_BATCH}: wall {plain_wall:.4f} s unprofiled, "
        f"{wall:.4f} s profiled; summed kernel time {busy:.4f} s = "
        f"{100 * busy / wall:.1f} % of the profiled wall")
    if busy <= 0:
        fail("the profiler saw no device time")
    groups = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other elementwise / copy")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e6
    for group, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {group:26s} {sec:8.4f} s {100 * sec / wall:6.2f} % of wall")
    for e in kernels[:12]:
        sec = e.self_device_time_total / 1e6
        log(f"[profile] {sec:8.4f} s {100 * sec / wall:6.2f} % {e.count:6d} calls  {e.key[:100]}")
    # per-call device time of the row-quant kernels by shape: the split-stream
    # tower calls each of them on the patch rows and then on the cls rows
    for name in ("ln_quant_kernel", "gelu_quant_kernel"):
        calls = sorted((e for e in prof.events()
                        if e.device_type == DeviceType.CUDA and name in e.name),
                       key=lambda e: e.time_range.start)
        patch = [e.time_range.elapsed_us() / 1e3 for e in calls[0::2]]
        cls = [e.time_range.elapsed_us() / 1e3 for e in calls[1::2]]
        if not cls or len(patch) != len(cls):
            fail(f"the profile holds {len(calls)} calls of {name}, not pairs")
        log(f"[profile] {name}: {len(patch)} calls at [{MC_BATCH * VIT_TOKENS}, K] "
            f"{sum(patch) / len(patch):.4f} ms each (min {min(patch):.4f}), {len(cls)} calls at "
            f"[{MC_BATCH}, K] {sum(cls) / len(cls):.4f} ms each (max {max(cls):.4f})")


# ----------------------------------------------------------------------
# phase 6: the flash attention forms of the ViT
# ----------------------------------------------------------------------
def phase_forms(torch, model, image, device):
    """The main path's model under ``vit_attn_impl`` flash_custom and flash:
    configs parsed from the certify model block with the form changed,
    around the same parameter tensors. Their towers agree with the
    flash_cls tower on 8 images; each form certifies the smoke image over
    two chunks (after one warm-up certification), beside flash_cls, with
    the launches counted. Returns the flash_custom run's launches."""
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, config_from_block

    models = {"flash_cls": model}
    for form in FLASH_FORMS:
        cfg = config_from_block(dict(CERTIFY_MODEL_BLOCK, vit_attn_impl=form))
        if cfg.vit.attn_impl != form:
            fail(f"config_from_block gave attn_impl {cfg.vit.attn_impl!r} for {form!r}")
        models[form] = MiniGPT4Model(cfg, model.params, model.tokenizer)

    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(8, *IMAGE_HWC).astype(np.float32)).to(device)
    vit = model.params["vit"]
    feats_cls = M.eva_vit_apply(vit, model.cfg.vit, images).float()
    for form in FLASH_FORMS:
        feats = M.eva_vit_apply(vit, models[form].cfg.vit, images).float()
        rel = float((feats - feats_cls).norm() / feats_cls.norm())
        log(f"[forms] ViT tokens under {form} {tuple(feats.shape)} vs flash_cls on 8 images: "
            f"relative error {rel:.3e}")
        if feats.shape != feats_cls.shape or not bool(torch.isfinite(feats).all()) \
                or not rel < 5e-2:
            fail(f"the {form} tower disagrees with the flash_cls tower")
        del feats
    del images, feats_cls
    torch.cuda.empty_cache()

    counted = {}
    for form, form_model in models.items():
        certify_item(form_model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)
        clock = StageClock(device)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = certify_item(form_model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG,
                           index=0, clock=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        chunks = clock.counts.get("noise", 0)
        vit_per_chunk = clock.seconds.get("vit", 0.0) / max(chunks, 1)
        log(f"[forms] certify under {form}: row {json.dumps(row)}")
        log(f"[forms] certify under {form}: wall {wall:.4f} s over {chunks} chunks, ViT "
            f"{vit_per_chunk:.4f} s per chunk; stage seconds "
            f"{json.dumps(stage_seconds(clock, wall))}; launches {json.dumps(launches)}")
        check_row(row, TWO_CHUNK_RUN_CFG)
        check_counts(f"certify {form}", launches, PER_CHUNK[form], chunks)
        counted[form] = launches
    return counted["flash_custom"]


# ----------------------------------------------------------------------
# phase 7: the kernels' own entry points
# ----------------------------------------------------------------------
def phase_entries(torch, device):
    """``noisy_tile``'s kernel mode and ``cls_split_attention_scaled``, which
    no certify path calls (as in the JAX package), each driven once through
    its entry at the main path's shapes, its launches counted."""
    import numpy as np

    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops.noise import noisy_tile

    x = torch.from_numpy(np.random.RandomState(0).randn(*IMAGE_HWC).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(11)
    g = torch.Generator(device=device).manual_seed(12)
    d = VIT_HEAD_DIM
    qkv = [torch.randn((MC_BATCH, VIT_HEADS, VIT_SEQ, d), generator=g, device=device)
           .to(torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    counted = {}
    for name, run, shape in (
        ("noisy_tile_kernel",
         lambda: noisy_tile(x, MC_BATCH, RUN_CFG["noise_level"], gen, use_kernel=True),
         (MC_BATCH,) + IMAGE_HWC),
        ("cls_split_attention_scaled",
         lambda: FA.cls_split_attention_scaled(*qkv, d), (MC_BATCH, VIT_HEADS, VIT_SEQ, d)),
    ):
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"[entry] {name}: output {tuple(out.shape)}; launches {json.dumps(launches)}")
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"{name}: output {tuple(out.shape)} is not finite or not {shape}")
        check_counts(name, launches, {name: 1}, 1)
        counted[name] = launches[name]
    return counted


# ----------------------------------------------------------------------
# phase 9.1 and 9.2: the look-ahead window and the early exit
# ----------------------------------------------------------------------
def phase_lookahead(torch, model, image, card, main_summary):
    """9.1: ``certify_item`` on phase 4's model and image with no clock, at
    (dispatch_window, early_exit) in ``LOOKAHEAD_RUNS``' order, one
    process: wall and decode steps launched per chunk, peak memory; the
    labels of every draw and the rows must be identical across the runs,
    and window 4's peak within phase 4's plus three noisy-image buffers.
    9.2: one chunk of the serial and one of the mixed pipeline dispatched,
    from the noise draw to the tokens' event, under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the 9.1 table."""
    from unittest import mock

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    make_sample_fn = A.make_sample_fn
    drawn = []

    def recording(*args, **kwargs):
        fn = make_sample_fn(*args, **kwargs)

        def sample_fn(*a, **k):
            labels = fn(*a, **k)
            drawn[-1].append(labels.tolist())
            return labels

        return sample_fn

    chunks = -(-LOOKAHEAD_RUN_CFG["certify_n0"] // MC_BATCH) \
        - (-LOOKAHEAD_RUN_CFG["certify_n"] // MC_BATCH)
    # phase 4's peak and three more chunks' noisy images, [96, 448, 448, 3] f32
    limit = main_summary["peak_gb"] + 3 * MC_BATCH * math.prod(IMAGE_HWC) * 4 / 1e9
    table, first = [], None
    with mock.patch.object(A, "make_sample_fn", recording):
        for window, early in LOOKAHEAD_RUNS:
            run_cfg = dict(LOOKAHEAD_RUN_CFG, dispatch_window=window, early_exit=early)
            drawn.append([])
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            M.generate.decode_steps = 0
            t0 = time.perf_counter()
            row = A.certify_item(model, image, QUESTION, GT_ANSWERS, run_cfg, index=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            steps = M.generate.decode_steps / chunks
            entry = {"window": window, "early_exit": early, "s_per_chunk": wall / chunks,
                     "decode_steps_per_chunk": steps, "peak_gb": peak}
            table.append(entry)
            log(f"[lookahead] window {window}, early_exit {early}: {wall / chunks:.4f} s a chunk "
                f"over {chunks} chunks, {steps:g} decode steps launched a chunk, peak memory "
                f"{peak:.2f} GB; {card}")
            check_row(row, run_cfg)
            key = ({k: v for k, v in row.items() if k != "seconds"}, drawn[-1])
            if first is None:
                first = key
            elif key != first:
                fail(f"window {window}, early_exit {early}: labels or row differ from the "
                     f"first run's ({json.dumps(key[0])} vs {json.dumps(first[0])})")
            if window > 1 and peak > limit:
                fail(f"window {window}: peak memory {peak:.2f} GB over phase 4's "
                     f"{main_summary['peak_gb']:.2f} GB plus three noisy-image buffers")
    if sum(len(labels) for labels in first[1]) != LOOKAHEAD_RUN_CFG["certify_n0"] + \
            LOOKAHEAD_RUN_CFG["certify_n"]:
        fail(f"phase 9.1 drew {[len(x) for x in first[1]]} labels, not the whole budget")
    log(f"[lookahead] table {json.dumps(table)}")
    check_no_sync(torch, model, image, card)
    check_early_exit_fires(torch, model.device, card)
    return table


def check_no_sync(torch, model, image, card):
    """Phase 9.2: dispatching a chunk, from the noise draw to the event
    behind its tokens' copy, never makes PyTorch wait for the card: the
    serial pipeline (``make_noisy_generate_fn``, early exit on) and the
    mixed one (``make_mixed_generate_fn``, with the uploads of its banks and
    row slots) under ``set_sync_debug_mode("error")``."""
    import numpy as np

    from certifiedgpt_tpu_torch.data.loader import HostCopy, upload
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.smoothing.classifier import chunk_seed, make_noisy_generate_fn
    from certifiedgpt_tpu_torch.smoothing.continuous import make_mixed_generate_fn

    device = model.device
    seq_len, steps, sigma = RUN_CFG["seq_len"], RUN_CFG["max_new_tokens"], RUN_CFG["noise_level"]
    prompt = build_gen_batch(model.tokenizer, [QUESTION],
                             BatchSpec(seq_len=seq_len, num_img_tokens=model.cfg.num_img_tokens))
    serial = make_noisy_generate_fn(model, sigma, MC_BATCH, steps, seq_len=seq_len,
                                    early_exit=True)
    slots = 8
    mixed = make_mixed_generate_fn(model, MC_BATCH, steps, slots, seq_len=seq_len,
                                   early_exit=True)
    x = upload(image, device)
    p_ids, p_am, p_pos = (upload(prompt[k], device).long()
                          for k in ("input_ids", "attention_mask", "img_pos"))
    bank = x.unsqueeze(0).repeat(slots, 1, 1, 1)
    banks = [np.repeat(prompt[k].astype(np.int64), slots, 0)
             for k in ("input_ids", "attention_mask", "img_pos")]
    rows = np.arange(MC_BATCH, dtype=np.int64) % slots

    def dispatch_serial():
        g = torch.Generator(device=device)
        g.manual_seed(chunk_seed(42, 0))
        return HostCopy(serial(x, p_ids, p_am, p_pos, g))

    def dispatch_mixed():
        g = torch.Generator(device=device)
        g.manual_seed(chunk_seed(42, 0))
        return HostCopy(mixed(bank, *(upload(b, device) for b in banks), upload(rows, device),
                              g, sigma))

    for name, dispatch in (("serial", dispatch_serial), ("mixed", dispatch_mixed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = dispatch()
        except RuntimeError as exc:
            fail(f"phase 9.2: dispatching a {name} chunk made the host wait for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        queued = time.perf_counter() - t0
        tokens = pending.numpy()
        wall = time.perf_counter() - t0
        if tokens.shape != (MC_BATCH, steps) or tokens.min() < 0 \
                or tokens.max() >= model.cfg.llama.vocab_size:
            fail(f"phase 9.2: the {name} chunk's tokens are malformed: {tokens.shape}")
        log(f"[nosync] a {name} chunk dispatched without a sync (set_sync_debug_mode "
            f"'error'): queued in {queued:.4f} s, tokens on the host after {wall:.4f} s; {card}")


def chain_model(torch, device):
    """Phase 9.2's tiny model whose decoder weights send each row's last
    prompt token along a chain to EOS (``EXIT_CHAINS``), and its batch of
    ``EXIT_ROWS`` rows, which end at different steps."""
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    eos = 2
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, device)
    llama = model.params["llama"]
    for name in ("o_proj", "down_proj"):  # attention and MLP add nothing
        for leaf in llama["layers"][name].values():
            leaf.zero_()
    emb = llama["embed_tokens"]["embedding"]
    d = emb.shape[1]
    emb.copy_(torch.eye(d, device=device)[torch.arange(emb.shape[0], device=device) % d])
    head = llama["lm_head"]["kernel"]  # each one-hot to its successor
    head.copy_(torch.eye(d, head.shape[1], device=device))
    for first, chain in EXIT_CHAINS:
        seq = (first, *chain, eos)
        for a, b in zip(seq, seq[1:]):
            head[a, a] = 0.0
            head[a, b] = 1.0
    if llama["lm_head"].get("bias") is not None:
        llama["lm_head"]["bias"].zero_()
    llama["norm"]["scale"].fill_(1.0)
    seq_len, img = 40, model.cfg.vit.img_size
    ids = torch.full((len(EXIT_ROWS), seq_len), 5, dtype=torch.long, device=device)
    ids[:, -1] = torch.tensor([EXIT_CHAINS[r][0] for r in EXIT_ROWS], device=device)
    batch = {"image": torch.randn((len(EXIT_ROWS), img, img, 3), device=device),
             "input_ids": ids, "attention_mask": torch.ones_like(ids),
             "img_pos": torch.full((len(EXIT_ROWS),), 2, dtype=torch.long, device=device)}
    return model, batch


def check_early_exit_fires(torch, device, card):
    """Phase 9.2, the early exit firing on the card: on ``chain_model``,
    with the exit on, the tokens equal the full loop's (and the chains'),
    the host launched at least the steps until the last EOS and fewer than
    the full loop's, and neither call of ``generate`` made the host wait for
    the card."""
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    eos, pad = 2, 0
    model, batch = chain_model(torch, device)
    rows = EXIT_ROWS
    want = [list(EXIT_CHAINS[r][1]) + [eos] for r in rows]
    want = [t + [pad] * (EXIT_STEPS - len(t)) for t in want]
    longest = max(len(t) for t in (EXIT_CHAINS[r][1] for r in rows)) + 1
    M.generate(model.params, model.cfg, batch, EXIT_STEPS, eos, pad)  # warm-up
    outs, launched = {}, {}
    for early in (False, True):
        M.generate.decode_steps = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = M.generate(model.params, model.cfg, batch, EXIT_STEPS, eos, pad,
                             early_exit=early)
        except RuntimeError as exc:
            fail(f"phase 9.2: generate (early_exit {early}) made the host wait for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs[early] = out.cpu().tolist()
        launched[early] = M.generate.decode_steps
    if outs[True] != outs[False] or outs[False] != want:
        fail(f"phase 9.2: early exit tokens {outs[True]} differ from the full loop's "
             f"{outs[False]} or the chains' {want}")
    if launched[False] != EXIT_STEPS - 1 or not longest <= launched[True] < EXIT_STEPS - 1:
        fail(f"phase 9.2: {launched[True]} decode steps launched with the exit firing and "
             f"{launched[False]} without; want {longest} to {EXIT_STEPS - 2}, and "
             f"{EXIT_STEPS - 1}")
    log(f"[nosync] early exit firing (tiny model, weights chain tokens to EOS; the last row "
        f"done after {longest} steps): {launched[True]} decode steps launched, "
        f"{launched[False]} without the exit; tokens equal to the full loop's; no sync "
        f"(set_sync_debug_mode 'error'); {card}")


# ----------------------------------------------------------------------
# phases 8, 9.3 and 10: the launcher on shipped configs
# ----------------------------------------------------------------------
LAUNCH_RUNS = (  # mode, shipped config (run unchanged), results file
    ("certify", "configs/certify_configs/vqav2_certify_noise_0.5.yaml", "certify"),
    ("smoothing_predict", "configs/certify_configs/vqav2_predict_noise_0.5.yaml", "predict"),
)
CONTINUOUS_CONFIG = "configs/certify_configs/vqav2_certify_continuous.yaml"
EVAL_CONFIG = "configs/eval_configs/vqav2_eval_noise_0.5.yaml"
# the dataset's size caps the configs' max_images
LAUNCH_IMAGES = 2
CONTINUOUS_IMAGES = 3  # fewer than the 8 slots: every chunk mixes images
EVAL_QUESTIONS = 10  # two batches of 8, the second padded from 2 rows
LAUNCH_ROW_KEYS = {
    "certify": {"index", "question_id", "label", "answer", "radius", "correct", "abstain",
                "seconds", "sigma", "n0", "n", "draws"},
    "predict": {"index", "question_id", "label", "answer", "correct", "abstain", "seconds",
                "sigma", "n", "draws"},
    "continuous": {"index", "question_id", "label", "answer", "radius", "correct", "abstain",
                   "elapsed_seconds", "sigma", "n0", "n", "draws"},
}
LAUNCH_SUMMARY_KEYS = {
    "certify": {"total", "sigma", "n0", "n", "alpha", "abstention_rate", "standard_accuracy",
                "certified_accuracy_at_radius", "mean_draws_per_image",
                "mean_seconds_per_image"},
    "predict": {"total", "sigma", "n", "alpha", "accuracy", "abstention_rate",
                "mean_seconds_per_image", "mean_draws_per_image"},
}
LAUNCH_SUMMARY_KEYS["continuous"] = LAUNCH_SUMMARY_KEYS["certify"] | {"continuous",
                                                                      "images_per_hour"}
EVAL_SUMMARY_KEYS = {"overall_accuracy", "per_answer_type", "per_question_type", "exact_match",
                     "token_f1", "answer_bias", "num_questions", "noise_level"}
# model-block paths of the shipped configs, pointed where nothing exists so
# that the model is built from its seed
CHECKPOINT_ENV = ("VICUNA_7B", "EVA_VIT_G", "QFORMER_CKPT", "MINIGPT4_STAGE2")


def write_vqa_set(root, n: int) -> None:
    """``n`` seeded 640x480 RGB JPEGs named as COCO val2014 images, and
    VQAv2-shaped question and annotation JSONs with 10 answers each."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    (root / "images").mkdir()
    questions, annotations = [], []
    for i in range(n):
        image_id = 9000 + i
        Image.fromarray(rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)).save(
            root / "images" / f"COCO_val2014_{image_id:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": image_id,
                          "question": "what animal is this?"})
        annotations.append({
            "question_id": i + 1, "image_id": image_id, "question_type": "what",
            "answer_type": "other",
            "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j + 1}
                        for j, a in enumerate(GT_ANSWERS)],
        })
    (root / "questions.json").write_text(json.dumps({"questions": questions}))
    (root / "annotations.json").write_text(json.dumps({"annotations": annotations}))


def write_finetuned(path, d_in: int, d_out: int):
    """A ``llama_proj`` checkpoint in the JAX package's ``.npz`` format
    (``model:`` + the parameter path, and an empty meta sidecar), seeded
    values unlike the synthetic init (whose bias is zero)."""
    import numpy as np

    rng = np.random.RandomState(7)
    arrays = {"model:llama_proj/kernel": (rng.randn(d_in, d_out) / math.sqrt(d_in))
              .astype(np.float32),
              "model:llama_proj/bias": (0.1 * rng.randn(d_out)).astype(np.float32)}
    np.savez(path, **arrays)
    with open(f"{path}.meta.json", "w") as handle:
        json.dump({}, handle)
    return arrays


def launch_files(root, n: int, d_in: int, d_out: int):
    """A written set of ``n`` images and a ``llama_proj`` checkpoint under
    ``root``; returns the environment the shipped YAMLs read (checkpoint
    paths of the model block where nothing exists) and the checkpoint."""
    write_vqa_set(root, n)
    ckpt = root / "vqav2_finetuned.npz"
    proj = write_finetuned(ckpt, d_in, d_out)
    env = {"VQAV2_IMAGES": str(root / "images"),
           "VQAV2_VAL_QUESTIONS": str(root / "questions.json"),
           "VQAV2_VAL_ANNOTATIONS": str(root / "annotations.json"),
           "VQA_FINETUNED": str(ckpt),
           **{name: str(root / "absent" / name.lower()) for name in CHECKPOINT_ENV}}
    return env, proj


def run_launch(torch, argv, env, out):
    """``launch.main(argv)`` with ``env`` (and ``OUTPUT_DIR=out``) set and
    ``encode_img`` spied on, the launch counters reset just before and read
    just after. Returns the summary, the CLI wall, the launches, the
    projection each ``encode_img`` call read (one call a chunk or a batch),
    the decode steps launched, the peak memory, the model build seconds
    (``certified.log``) and the card's state during the run."""
    import re
    from unittest import mock

    from certifiedgpt_tpu_torch import launch
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    encode_img = M.encode_img
    seen = []

    def spy(params, cfg, images, clock=None):
        seen.append(params["llama_proj"])
        return encode_img(params, cfg, images, clock)

    with mock.patch.dict(os.environ, dict(env, OUTPUT_DIR=str(out))), \
            mock.patch.object(M, "encode_img", spy), CardSampler() as card_state:
        reset_counts()
        M.generate.decode_steps = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = launch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    build = re.search(r"built model minigpt4 on \w+ in ([0-9.]+) s",
                      (out / "certified.log").read_text())
    if build is None:
        fail(f"{argv[0]}: certified.log has no model build line")
    return {"summary": summary, "wall": wall, "launches": launches, "seen": seen,
            "decode_steps": M.generate.decode_steps,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "build_s": float(build.group(1)), "card_state": card_state.summary()}


def check_projection(label, seen, proj, calls):
    """``encode_img`` ran ``calls`` times and read exactly the checkpoint's
    projection every time."""
    import torch

    if len(seen) != calls:
        fail(f"{label}: {len(seen)} encode_img calls for {calls} chunks or batches")
    ptrs = {(p["kernel"].data_ptr(), p["bias"].data_ptr()) for p in seen}
    if len(ptrs) != 1:
        fail(f"{label}: encode_img read {len(ptrs)} different projections")
    for key in ("kernel", "bias"):
        want = torch.from_numpy(proj[f"model:llama_proj/{key}"]).to(seen[0][key].device)
        if seen[0][key].dtype != torch.float32 or not torch.equal(seen[0][key], want):
            fail(f"{label}: the llama_proj {key} encode_img read is not the checkpoint's")


def read_rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def dispatched_chunks(row, n0: int, n: int, mc_batch: int, window: int) -> int:
    """Chunks of ``mc_batch`` draws a serial row's certification or
    prediction dispatched: certify's selection pass (``n0``) runs whole;
    the estimation pass (or predict's one pass) reads chunks until an early
    stop, which keeps up to ``window`` chunks dispatched past the last one
    read (abandoned in flight), never more than the pass has."""
    used = -(-(row["draws"] - n0) // mc_batch)
    return -(-n0 // mc_batch) + min(-(-n // mc_batch), used + window)


def check_certify_rows(label, rows, kind, count, budget, sigma):
    if len(rows) != count or any(set(r) != LAUNCH_ROW_KEYS[kind] for r in rows):
        fail(f"{label}: rows {rows} are not {count} rows with the JAX package's keys")
    for row in rows:
        if row["sigma"] != sigma or row["abstain"] != (row["label"] == -1) \
                or not 0 < row["draws"] <= budget \
                or not math.isfinite(row.get("radius", 0.0)) or row.get("radius", 0.0) < 0:
            fail(f"{label}: malformed row {row}")


# ----------------------------------------------------------------------
# phase 8: the launcher on the shipped certify and predict configs
# ----------------------------------------------------------------------
def phase_launcher(torch, card, d_in: int, d_out: int, main_summary):
    """``certifiedgpt_tpu_torch.launch.main`` on the shipped certify and
    predict YAMLs, unchanged (full width; the synthetic dataset of
    ``LAUNCH_IMAGES`` images caps ``max_images``; ``dispatch_window`` 4 by
    default), with ``vqa_finetuned`` pointing at a written projection
    checkpoint. Checks the rows and summaries against the JAX package's
    schema, that ``encode_img`` read exactly the checkpoint's projection,
    and that each path kernel launched its launches per chunk times the
    chunks dispatched. Returns each run's launches and rows."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    counted, rows_of = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, LAUNCH_IMAGES, d_in, d_out)
        for mode, path, kind in LAUNCH_RUNS:
            out = root / f"out_{kind}"
            knobs = A.SmoothingKnobs.from_run(Config(path).run)
            res = run_launch(torch, [mode, "--config-path", path], env, out)
            summary = res["summary"]
            rows = read_rows(out / f"{kind}_results.jsonl")
            on_disk = json.loads((out / f"{kind}_summary.json").read_text())
            log(f"[launch] {mode} {path}: rows {json.dumps(rows)}")
            log(f"[launch] {mode}: summary {json.dumps(summary)}; launches "
                f"{json.dumps(res['launches'])}")
            n0 = knobs.n0 if kind == "certify" else 0
            n = knobs.n if kind == "certify" else knobs.predict_n
            check_certify_rows(mode, rows, kind, LAUNCH_IMAGES, n0 + n, knobs.sigma)
            if summary != on_disk or set(summary) != LAUNCH_SUMMARY_KEYS[kind] \
                    or summary["total"] != LAUNCH_IMAGES:
                fail(f"{mode}: summary {summary} does not have the JAX package's keys")
            chunks = sum(dispatched_chunks(r, n0, n, knobs.mc_batch, knobs.dispatch_window)
                         for r in rows)
            check_projection(mode, res["seen"], proj, chunks)
            check_counts(f"launch {mode}", res["launches"], PER_CHUNK["flash_cls"], chunks)
            row_s = sum(r["seconds"] for r in rows)
            line = (f"[launch] {mode}: dispatch_window {knobs.dispatch_window}; model build "
                    f"{res['build_s']:.3f} s; CLI wall {res['wall']:.3f} s, of which rows "
                    f"{row_s:.3f} s and other agent time {res['wall'] - res['build_s'] - row_s:.3f} s; "
                    f"{row_s / len(rows):.3f} s per "
                    f"{'certified' if kind == 'certify' else 'predicted'} image over {chunks} "
                    f"chunks dispatched ({row_s / chunks:.4f} s a chunk")
            if kind == "certify":
                per_chunk = main_summary["wall_seconds"] / main_summary["chunks"]
                line += f"; certify_item in phase 4, window 1 and a clock: {per_chunk:.4f} s a chunk"
            log(f"{line}); {res['decode_steps']} decode steps launched; peak memory "
                f"{res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
            counted[mode] = res["launches"]
            rows_of[kind] = rows
            gc.collect()
            torch.cuda.empty_cache()
    return counted, rows_of


# ----------------------------------------------------------------------
# phase 9.3: the continuous scheduler on the shipped continuous config
# ----------------------------------------------------------------------
def phase_continuous(torch, card, d_in: int, d_out: int, serial_rows):
    """``launch.main`` on ``vqav2_certify_continuous.yaml`` unchanged
    (``active_images`` 8, ``dispatch_window`` 4) over ``CONTINUOUS_IMAGES``
    written images: every chunk mixes images. The rows have the JAX
    package's continuous keys, each certifies OTHER at the radius of phase
    8's serial rows after all its draws; the chunks dispatched are
    ceil(images x (n0 + n) / mc_batch), each with the path's launches.
    Returns the launches."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    knobs = A.SmoothingKnobs.from_run(Config(CONTINUOUS_CONFIG).run)
    if not knobs.continuous:
        fail(f"{CONTINUOUS_CONFIG} does not set run.continuous")
    budget = knobs.n0 + knobs.n
    chunks = -(-CONTINUOUS_IMAGES * budget // knobs.mc_batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_continuous_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, CONTINUOUS_IMAGES, d_in, d_out)
        out = root / "out_continuous"
        res = run_launch(torch, ["certify", "--config-path", CONTINUOUS_CONFIG], env, out)
        summary = res["summary"]
        rows = read_rows(out / "certify_results.jsonl")
        on_disk = json.loads((out / "certify_summary.json").read_text())
    log(f"[continuous] {CONTINUOUS_CONFIG}: rows {json.dumps(rows)}")
    log(f"[continuous] summary {json.dumps(summary)}; launches {json.dumps(res['launches'])}")
    check_certify_rows("continuous", rows, "continuous", CONTINUOUS_IMAGES, budget, knobs.sigma)
    if summary != on_disk or set(summary) != LAUNCH_SUMMARY_KEYS["continuous"] \
            or summary["continuous"] is not True or summary["total"] != CONTINUOUS_IMAGES:
        fail(f"continuous: summary {summary} does not have the JAX package's keys")
    radius = serial_rows["certify"][0]["radius"]
    for row in rows:
        if row["answer"] != "<other>" or row["radius"] != radius or row["draws"] != budget:
            fail(f"continuous: row {row} is not OTHER at radius {radius} after {budget} draws")
    check_projection("continuous", res["seen"], proj, chunks)
    check_counts("launch continuous", res["launches"], PER_CHUNK["flash_cls"], chunks)
    per_image = summary["mean_seconds_per_image"]
    serial = sum(r["seconds"] for r in serial_rows["certify"]) / len(serial_rows["certify"])
    log(f"[continuous] {chunks} chunks dispatched for {CONTINUOUS_IMAGES} images "
        f"(serial: {CONTINUOUS_IMAGES * (-(-knobs.n0 // knobs.mc_batch) - (-knobs.n // knobs.mc_batch))}); "
        f"{per_image:.3f} s per certified image (wall / images, the agent's), "
        f"{summary['images_per_hour']:.1f} images an hour, against {serial:.3f} s per image "
        f"serially in phase 8; {per_image * CONTINUOUS_IMAGES / chunks:.4f} s a chunk; "
        f"model build {res['build_s']:.3f} s, CLI wall {res['wall']:.3f} s; "
        f"{res['decode_steps']} decode steps launched; peak memory {res['peak_gb']:.2f} GB; "
        f"{card}; card during the run: {res['card_state']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


# ----------------------------------------------------------------------
# phase 10: the eval agent on a shipped eval config
# ----------------------------------------------------------------------
def phase_eval(torch, card, d_in: int, d_out: int):
    """``launch.main`` in ``eval`` mode on ``vqav2_eval_noise_0.5.yaml``
    unchanged (batch 8, seq_len 320, early exit, ``dispatch_window`` 2 by
    default) over ``EVAL_QUESTIONS`` written questions: two batches, the
    second padded from 2 rows to 8. ``eval_results.json`` has the JAX
    package's summary keys and a prediction for every question; each batch
    ran the path's launches. Returns the launches."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.common.config import Config

    run = Config(EVAL_CONFIG).run
    batch = int(run.get("batch_size"))
    batches = -(-EVAL_QUESTIONS // batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, EVAL_QUESTIONS, d_in, d_out)
        out = root / "out_eval"
        res = run_launch(torch, ["eval", "--config-path", EVAL_CONFIG], env, out)
        saved = json.loads((out / "eval_results.json").read_text())
    summary = res["summary"]
    log(f"[eval] {EVAL_CONFIG}: summary {json.dumps(summary)}; first predictions "
        f"{json.dumps(saved['predictions'][:3])}; launches {json.dumps(res['launches'])}")
    if saved["summary"] != summary or set(summary) != EVAL_SUMMARY_KEYS \
            or summary["num_questions"] != EVAL_QUESTIONS:
        fail(f"eval: summary {summary} does not have the JAX package's keys")
    if sorted(p["question_id"] for p in saved["predictions"]) != list(range(1, EVAL_QUESTIONS + 1)):
        fail(f"eval: predictions {saved['predictions']} do not cover the questions")
    check_projection("eval", res["seen"], proj, batches)
    check_counts("launch eval", res["launches"], PER_CHUNK["flash_cls"], batches)
    agent_s = res["wall"] - res["build_s"]
    log(f"[eval] {EVAL_QUESTIONS} questions in {batches} batches of {batch}: "
        f"{EVAL_QUESTIONS / agent_s:.3f} samples per second over the agent's run "
        f"({agent_s:.3f} s: dataset, JPEG decode, generate, scoring), "
        f"{EVAL_QUESTIONS / res['wall']:.3f} over the CLI wall ({res['wall']:.3f} s, model "
        f"build {res['build_s']:.3f} s); {res['decode_steps']} decode steps launched; peak "
        f"memory {res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


# ----------------------------------------------------------------------
# phase 11: training on the shipped VQAv2 finetuning configs
# ----------------------------------------------------------------------
TRAIN_W8A8_CONFIG = "configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml"
TRAIN_BF16_CONFIG = "configs/train_configs/vqav2_finetuning_noise_0.5.yaml"
# each run with max_epoch cut to this (its only change), inside the time limit
TRAIN_EPOCHS = 3
# a written VQAv2-shaped set: two train steps of 48 an epoch, one val batch
TRAIN_SAMPLES = 96
VAL_SAMPLES = 48
# 11.1 limits, kernels against their plain versions on one full-width batch
# of the _w8a8 config. The ViT's tokens agree within 5e-2 (phase 4's limit;
# 2.3e-2 measured), the projected image tokens within ~1.2e-2, and the loss
# averages over every answer token. The W8A8 decoder's backward amplifies
# a change of its image tokens ~25x: its int8 activation codes flip (one
# H100 at 700 W: the loss's gradient in the tokens 3.1e-1 apart, the
# projection's 8.9e-2; the controls below print a random change of the
# tokens of the same size, and the same decoder with weight-only int8
# products)
TRAIN_LOSS_REL_LIMIT = 1e-2
TRAIN_GRAD_REL_LIMIT = 0.25
# the projection's gradient with the decoder's activation quant off
# (weight-only int8 products): no codes to flip
WEIGHT_ONLY_GRAD_REL_LIMIT = 5e-2
# one decoder layer's straight-through backward against autograd through the
# same layer with the int8 kernels dequantized to bf16 and no activation
# quant: they differ only by the forward's int8 activation rounding (~1 %)
LAYER_GRAD_REL_LIMIT = 5e-2
# kernel launches a train step (and a val batch) of 48 images: the ViT once;
# the bf16 towers run no row-quant kernel
PER_TRAIN_STEP = {
    "w8a8": PER_CHUNK["flash_cls"],
    "bf16": {"cls_split_attention": VIT_DEPTH},
}


def write_train_set(root) -> dict:
    """Seeded 640x480 JPEGs named as COCO train2014 (``TRAIN_SAMPLES``) and
    val2014 (``VAL_SAMPLES``) images with VQAv2-shaped question and
    annotation JSONs; returns the environment the train YAMLs read (the
    model block's checkpoint paths where nothing exists)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(3)
    (root / "train_images").mkdir()
    env = {"VQAV2_IMAGES": str(root / "train_images"),
           **{name: str(root / "absent" / name.lower()) for name in CHECKPOINT_ENV}}
    for split, n, base in (("train", TRAIN_SAMPLES, 20000), ("val", VAL_SAMPLES, 30000)):
        questions, annotations = [], []
        for i in range(n):
            image_id = base + i
            Image.fromarray(rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)).save(
                root / "train_images" / f"COCO_{split}2014_{image_id:012d}.jpg")
            questions.append({"question_id": image_id, "image_id": image_id,
                              "question": "what animal is this?"})
            annotations.append({
                "question_id": image_id, "image_id": image_id, "question_type": "what",
                "answer_type": "other",
                "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j + 1}
                            for j, a in enumerate(GT_ANSWERS)]})
        for kind, rows in (("QUESTIONS", {"questions": questions}),
                           ("ANNOTATIONS", {"annotations": annotations})):
            path = root / f"{split}_{kind.lower()}.json"
            path.write_text(json.dumps(rows))
            env[f"VQAV2_{split.upper()}_{kind}"] = str(path)
    return env


def config_with_run(path: str, out, **run):
    """A copy of the shipped YAML ``path`` at ``out`` with only the run
    block's ``run`` keys set; its ``${env:...}`` values stay as written."""
    import yaml

    with open(path) as handle:
        cfg = yaml.safe_load(handle)
    cfg["run"].update(run)
    out.write_text(yaml.safe_dump(cfg))
    return out


def cut_config(path: str, root, epochs: int):
    """A copy of the shipped YAML ``path`` with only ``run.max_epoch`` set to
    ``epochs``."""
    return config_with_run(path, root / os.path.basename(path), max_epoch=epochs)


def plain_versions():
    """Patches that route the path's kernels to their plain versions."""
    from unittest import mock

    from certifiedgpt_tpu_torch.models import eva_vit as V
    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops import quantization as Q

    return [mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain),
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain),
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_as_plain)]


def phase_train_checks(torch, card, device, root, env):
    """11.1: on one full-width batch of the ``_w8a8`` config (48 written
    448 px images, pack 3, seq_len 256) the loss and the ``llama_proj``
    gradient through the kernels against the same through their plain
    versions; one decoder layer's straight-through backward against a
    dequantized bf16 reference; a batch whose last packed row is all
    padding gives a finite loss and finite gradients."""
    import dataclasses
    from unittest import mock

    from certifiedgpt_tpu_torch import registration  # noqa: F401 (the agents)
    from certifiedgpt_tpu_torch.agents.base import setup_agent
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.models import layers as L
    from certifiedgpt_tpu_torch.models import llama as LL
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    with mock.patch.dict(os.environ, dict(env, OUTPUT_DIR=str(root / "out_checks"))):
        agent = setup_agent(Config(TRAIN_W8A8_CONFIG), device=device)
        host = next(iter(agent.create_loaders()["train"]))
    batch = agent.device_batch(host)
    model, cfg = agent.model, agent.model.cfg
    proj = model.module.llama_proj

    def loss_and_grad(b, offset=None, run_cfg=cfg):
        """The loss, the projection's gradient, the image tokens (plus
        ``offset``) and the loss's gradient in them (what the decoder's
        backward hands the projection), and whether the bias gradient is
        finite."""
        proj.kernel.grad = proj.bias.grad = None
        tokens = M.encode_img(model.params, run_cfg, b["image"])
        if offset is not None:
            tokens = tokens + offset
        tokens.retain_grad()
        loss = M.minigpt4_loss(model.params, run_cfg, b, img_embeds=tokens)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), proj.kernel.grad.clone(), tokens.detach(),
                tokens.grad, bool(torch.isfinite(proj.bias.grad).all()))

    loss_and_grad(batch)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    loss, grad, tokens, tokens_grad, _ = loss_and_grad(batch)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts("train 11.1", launches, PER_TRAIN_STEP["w8a8"], 1)
    weight_only = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, act_quant=False))
    wo_grad = loss_and_grad(batch, run_cfg=weight_only)[1]
    with contextlib.ExitStack() as stack:
        for patch in plain_versions():
            stack.enter_context(patch)
        plain_loss, plain_grad, plain_tokens, plain_tokens_grad, _ = loss_and_grad(batch)
        wo_plain_grad = loss_and_grad(batch, run_cfg=weight_only)[1]
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    grad_rel = rel_err(grad, plain_grad)
    wo_rel = rel_err(wo_grad, wo_plain_grad)
    # control: the plain tokens changed at random by as much as the kernels
    # change them
    g = torch.Generator(device=device).manual_seed(7)
    noise = torch.randn(plain_tokens.shape, generator=g, device=device)
    noise *= (tokens.float() - plain_tokens.float()).norm() / noise.norm()
    with contextlib.ExitStack() as stack:
        for patch in plain_versions():
            stack.enter_context(patch)
        control = loss_and_grad(batch, offset=noise.to(plain_tokens.dtype))
    rows, seq = batch["input_ids"].shape
    log(f"[train] 11.1 {TRAIN_W8A8_CONFIG}: batch of {batch['image'].shape[0]} images as "
        f"{rows} packed rows x {seq}: loss {loss:.6f} through the kernels, {plain_loss:.6f} "
        f"through their plain versions (relative error {loss_rel:.3e}, limit "
        f"{TRAIN_LOSS_REL_LIMIT:g}); llama_proj gradient relative error (Frobenius) "
        f"{grad_rel:.3e} (limit {TRAIN_GRAD_REL_LIMIT:g}); on the way: projected image tokens "
        f"{rel_err(tokens, plain_tokens):.3e}, the loss's gradient in them (the decoder's "
        f"backward) {rel_err(tokens_grad, plain_tokens_grad):.3e}; forward + backward "
        f"{seconds:.3f} s; launches {json.dumps(launches)}; {card}")
    log(f"[train] 11.1 controls: the plain path with its image tokens changed at random by as "
        f"much: the loss's gradient in them {rel_err(control[3], plain_tokens_grad):.3e}, the "
        f"projection's {rel_err(control[1], plain_grad):.3e}; the decoder with weight-only "
        f"int8 products (no activation quant), kernels against plain versions: the "
        f"projection's gradient {wo_rel:.3e} (limit {WEIGHT_ONLY_GRAD_REL_LIMIT:g})")
    if not (math.isfinite(loss) and bool(torch.isfinite(grad).all())):
        fail("train 11.1: the loss or the llama_proj gradient is not finite")
    if not (loss_rel < TRAIN_LOSS_REL_LIMIT and grad_rel < TRAIN_GRAD_REL_LIMIT
            and wo_rel < WEIGHT_ONLY_GRAD_REL_LIMIT):
        fail("train 11.1: the loss or gradient through the kernels disagrees with the plain "
             "versions")

    # one decoder layer: the W8A8 straight-through backward against autograd
    # through the same layer with dequantized bf16 kernels
    g = torch.Generator(device=device).manual_seed(11)
    lp = L.layer_slice(model.params["llama"]["layers"], 0)
    lcfg = cfg.llama
    x = torch.randn((rows, seq, lcfg.hidden_size), generator=g, device=device).bfloat16()
    r = torch.randn((rows, seq, lcfg.hidden_size), generator=g, device=device)
    cos, sin = L.rotary_tables(lcfg.head_dim, lcfg.max_position_embeddings, lcfg.rope_theta,
                               device=device)
    mask = LL._training_mask(batch["attention_mask"], batch["segment_ids"], seq, device)

    def layer_grad(params, layer_cfg):
        xx = x.clone().requires_grad_(True)
        out = LL._block(xx, params, layer_cfg, cos, sin, batch["positions"], mask)
        (out.float() * r).sum().backward()
        return xx.grad

    dequantized = {name: {"kernel": (leaf["kernel_q"].float() * leaf["scale"]).bfloat16()}
                   if "kernel_q" in leaf else leaf for name, leaf in lp.items()}
    layer_rel = rel_err(layer_grad(lp, lcfg),
                        layer_grad(dequantized, dataclasses.replace(lcfg, act_quant=False)))
    log(f"[train] 11.1 decoder layer 0, W8A8 straight-through backward against a dequantized "
        f"bf16 layer at [{rows}, {seq}, {lcfg.hidden_size}]: input-gradient relative error "
        f"{layer_rel:.3e} (limit {LAYER_GRAD_REL_LIMIT:g})")
    if not layer_rel < LAYER_GRAD_REL_LIMIT:
        fail("train 11.1: the straight-through backward disagrees with the bf16 reference")

    # the last packed row all padding: every query of it fully masked
    padded = {k: v.clone() for k, v in batch.items()}
    for key, fill in (("input_ids", model.tokenizer.pad_token_id), ("attention_mask", 0),
                      ("labels", -100), ("segment_ids", 0), ("positions", 0)):
        padded[key][-1] = fill
    pad_loss, pad_grad, _, _, bias_ok = loss_and_grad(padded)
    finite = math.isfinite(pad_loss) and bool(torch.isfinite(pad_grad).all()) and bias_ok
    log(f"[train] 11.1 last packed row all padding: loss {pad_loss:.6f}, gradient finite "
        f"{finite}")
    if not finite:
        fail("train 11.1: a row of padding gives a loss or gradient that is not finite")

    # where a train step's time goes: each stage ends in a synchronize
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    proj.kernel.grad = proj.bias.grad = None
    tokens = M.encode_img(model.params, cfg, batch["image"])
    mark()
    loss = M.minigpt4_loss(model.params, cfg, batch, img_embeds=tokens)
    mark()
    loss.backward()
    mark()
    agent.optimizer.step()
    mark()
    parts = [b - a for a, b in zip(marks, marks[1:])]
    log(f"[train] 11.1 a train step's stages, each synchronized: ViT + Q-Former + projection "
        f"{parts[0]:.4f} s, decoder forward + loss {parts[1]:.4f} s, backward {parts[2]:.4f} s, "
        f"AdamW {parts[3]:.4f} s; {card}")
    del agent, model, batch, padded, grad, plain_grad, pad_grad, tokens, plain_tokens, loss
    del tokens_grad, plain_tokens_grad, control, wo_grad, wo_plain_grad
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_runs(torch, card, root, env):
    """11.2: ``launch.main(["train", ...])`` on the shipped ``_w8a8`` and
    bf16 VQAv2 finetuning YAMLs (``max_epoch`` cut to ``TRAIN_EPOCHS``),
    each train step and val batch timed (synchronized) with the kernels'
    launches counted; checks the losses, the artifacts and the launches.
    Returns each run's launches and the W8A8 run's output directory and
    initial projection."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.agents import finetune as F
    from certifiedgpt_tpu_torch.common.config import Config

    counted, w8a8 = {}, None
    for kind, path in (("w8a8", TRAIN_W8A8_CONFIG), ("bf16", TRAIN_BF16_CONFIG)):
        run = Config(path).run
        name = str(run.get("checkpoint_name"))
        cut = cut_config(path, root, TRAIN_EPOCHS)
        out = root / f"out_train_{kind}"
        calls = {"train": [], "val": []}
        first_proj = []

        def timed(split, original):
            def call(self, batch, *args):
                if not first_proj:
                    first_proj.append(self.model.module.llama_proj.kernel.detach().clone())
                torch.cuda.synchronize()
                before = read_counts()
                t0 = time.perf_counter()
                result = original(self, batch, *args)
                torch.cuda.synchronize()
                after = read_counts()
                calls[split].append((time.perf_counter() - t0,
                                     {k: after[k] - before[k] for k in after},
                                     batch["image"].shape[0], batch["input_ids"].numel()))
                return result
            return call

        with mock.patch.object(F.FinetuneAgent, "_train_step",
                               timed("train", F.FinetuneAgent._train_step)), \
                mock.patch.object(F.FinetuneAgent, "_eval_step",
                                  timed("val", F.FinetuneAgent._eval_step)):
            res = run_launch(torch, ["train", "--config-path", str(cut)], env, out)
        summary = res["summary"]
        history = json.loads((out / "loss_history.json").read_text())
        steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // int(run.get("batch_size")))
        log(f"[train] 11.2 {kind} {path} (max_epoch {TRAIN_EPOCHS}): summary "
            f"{json.dumps(summary)}; losses {json.dumps(history)}; launches "
            f"{json.dumps(res['launches'])}")
        if summary["steps"] != steps or summary["epochs"] != TRAIN_EPOCHS \
                or len(history["train"]) != TRAIN_EPOCHS or len(history["val"]) != TRAIN_EPOCHS \
                or not all(math.isfinite(v) for v in history["train"] + history["val"]):
            fail(f"train {kind}: {summary}, losses {history} are not {TRAIN_EPOCHS} finite "
                 f"epochs of {steps // TRAIN_EPOCHS} steps")
        files = {}
        for f in (f"{name}.npz", f"{name}.npz.meta.json", f"{name}_best.npz",
                  f"{name}_best.npz.meta.json", f"{name}.txt", "loss_history.json"):
            if not (out / f).exists():
                fail(f"train {kind}: {f} was not written")
            files[f] = (out / f).stat().st_size
        opt_keys = [k for k in np.load(out / f"{name}.npz").files if k.startswith("opt:")]
        if not opt_keys:
            fail(f"train {kind}: the resume checkpoint holds no optimizer state")
        per_step = PER_TRAIN_STEP[kind]
        for split, rows in calls.items():
            for _, launched, _, _ in rows:
                for kernel, n in launched.items():
                    if n != per_step.get(kernel, 0):
                        fail(f"train {kind} {split}: kernel {kernel} launched {n} times a "
                             f"step, expected {per_step.get(kernel, 0)}")
        if len(calls["train"]) != steps or len(calls["val"]) != TRAIN_EPOCHS:
            fail(f"train {kind}: {len(calls['train'])} train steps and {len(calls['val'])} "
                 f"val batches timed")
        times = sorted(t for t, _, _, _ in calls["train"][1:])
        median = times[len(times) // 2]
        _, _, samples, tokens = calls["train"][0]
        val = sorted(t for t, _, _, _ in calls["val"][1:])
        log(f"[train] 11.2 {kind}: {median:.4f} s a train step (median of {len(times)} after "
            f"the first, {calls['train'][0][0]:.4f} s; min {times[0]:.4f}, max "
            f"{times[-1]:.4f}), {samples / median:.2f} samples a second, {tokens / median:.1f} "
            f"decoder tokens a second ({samples} samples as {tokens} tokens a step); val batch "
            f"{val[len(val) // 2]:.4f} s (median after the first); peak memory "
            f"{res['peak_gb']:.2f} GB; model build {res['build_s']:.3f} s; CLI wall "
            f"{res['wall']:.3f} s; launches a train step and a val batch "
            f"{json.dumps(calls['train'][0][1])}; files {json.dumps(files)}; {card}; card during "
            f"the run: {res['card_state']}")
        counted[f"train {kind}"] = res["launches"]
        if kind == "w8a8":
            w8a8 = (out / f"{name}_best.npz", first_proj[0])
        gc.collect()
        torch.cuda.empty_cache()
    return counted, w8a8


def phase_train_predict(torch, card, root, best, initial, d_in, d_out):
    """11.3: the port's predict agent on phase 8's two images with
    ``model.vqa_finetuned`` the W8A8 run's ``_best`` checkpoint: every
    ``encode_img`` call reads that projection, which training moved away
    from the initial one."""
    import numpy as np

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    mode, path, kind = LAUNCH_RUNS[1]
    sub = root / "predict"
    sub.mkdir()
    env, _ = launch_files(sub, LAUNCH_IMAGES, d_in, d_out)
    env["VQA_FINETUNED"] = str(best)
    with np.load(best) as data:
        proj = {k: data[k] for k in data.files}
    if np.array_equal(proj["model:llama_proj/kernel"], initial.cpu().numpy()):
        fail("train 11.3: the trained projection equals the initial one")
    knobs = A.SmoothingKnobs.from_run(Config(path).run)
    out = sub / "out"
    res = run_launch(torch, [mode, "--config-path", path], env, out)
    rows = read_rows(out / f"{kind}_results.jsonl")
    check_certify_rows("train 11.3", rows, kind, LAUNCH_IMAGES, knobs.predict_n, knobs.sigma)
    chunks = sum(dispatched_chunks(r, 0, knobs.predict_n, knobs.mc_batch, knobs.dispatch_window)
                 for r in rows)
    check_projection("train 11.3", res["seen"], proj, chunks)
    log(f"[train] 11.3 {mode} {path} with vqa_finetuned {best.name}: every encode_img call "
        f"({chunks}) read the trained projection; rows {json.dumps(rows)}; {card}")
    return res["launches"]


def phase_train(torch, card, device, d_in: int, d_out: int):
    """Phase 11: 11.1, 11.2 and 11.3 on one written set. Returns the
    launches of each launcher run."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        env = write_train_set(root)
        phase_train_checks(torch, card, device, root, env)
        counted, (best, initial) = phase_train_runs(torch, card, root, env)
        counted["predict trained"] = phase_train_predict(torch, card, root, best, initial,
                                                         d_in, d_out)
    return counted


# ----------------------------------------------------------------------
# phase 12: the shipped certify config from full-width checkpoint files
# ----------------------------------------------------------------------
CKPT_SEED = 12
# the four files take ~16 GB: Vicuna 6.74 G parameters in bf16, the ViT
# 0.99 G in f16, the Q-Former ~0.11 G in f32
CKPT_DISK_GB = 20
CKPT_IMAGES = 1
# the safetensors dtype names of the tensors written
ST_DTYPES = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16"}
# the stacks' layers whose written tensors are kept to check the load
VICUNA_MODULES = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                  "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
                  "down_proj": "mlp"}
VIT_KERNELS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
# the tokenizer trained in the phase: a BPE over a small corpus, its
# vocabulary padded to the decoder's 32000 ids
TOKENIZER_CORPUS = ["what animal is this? a cat sits on the mat", "the dog runs fast",
                    "yes no two three blue red <Img> </Img> [vqa] [INST] [/INST]",
                    "based on the image, answer the question"] * 8


def write_safetensors(torch, path, specs, make):
    """A ``.safetensors`` file of ``specs`` [(name, shape, dtype)]: the
    header, then each tensor ``make(name, shape, dtype)`` copied to the host
    and written, one at a time."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, shape, dtype in specs:
        size = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": ST_DTYPES[str(dtype)], "shape": list(shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as handle:
        handle.write(struct.pack("<Q", len(blob)))
        handle.write(blob)
        for name, shape, dtype in specs:
            handle.write(make(name, shape, dtype).contiguous().cpu().reshape(-1)
                         .view(torch.uint8).numpy())
    return offset


class CheckpointWriter:
    """Seeded tensors drawn on the card for the four checkpoint files; the
    tensors the load checks read are kept on the host (``kept``)."""

    def __init__(self, torch, device, keep):
        self.torch, self.device, self.keep = torch, device, keep
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(CKPT_SEED)
        self.kept = {}

    def __call__(self, name, shape, dtype, std=0.02, offset=0.0):
        t = self.torch.randn(shape, generator=self.gen, device=self.device) * std + offset
        t = t.to(dtype)
        if self.keep(name):
            self.kept[name] = t.cpu()
        return t

    def linear(self, name, shape, dtype):
        """A Linear weight (std 1/sqrt(fan-in)), a norm's weight (1 +
        noise) or a bias, by name."""
        if name.endswith(("norm.weight", "LayerNorm.weight", "norm1.weight", "norm2.weight",
                          "layernorm.weight")):
            return self(name, shape, dtype, offset=1.0)
        if len(shape) == 2 and "embed" not in name and name != "lm_head.weight":
            return self(name, shape, dtype, std=shape[1] ** -0.5)
        return self(name, shape, dtype)


def vicuna_specs(torch, lc):
    """HF ``LlamaForCausalLM`` tensors in two shards: the embeddings and
    the first half of the layers, then the rest, the norm and the head."""
    d, inter, n = lc.hidden_size, lc.intermediate_size, lc.num_layers
    shapes = {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d), "o_proj": (d, d),
              "gate_proj": (inter, d), "up_proj": (inter, d), "down_proj": (d, inter)}

    def layer(i):
        p = f"model.layers.{i}."
        out = [(f"{p}{VICUNA_MODULES[m]}.{m}.weight", s, torch.bfloat16)
               for m, s in shapes.items()]
        return out + [(p + "input_layernorm.weight", (d,), torch.bfloat16),
                      (p + "post_attention_layernorm.weight", (d,), torch.bfloat16)]

    first = [("model.embed_tokens.weight", (lc.vocab_size, d), torch.bfloat16)]
    first += [spec for i in range(n // 2) for spec in layer(i)]
    second = [spec for i in range(n // 2, n) for spec in layer(i)]
    second += [("model.norm.weight", (d,), torch.bfloat16),
               ("lm_head.weight", (lc.vocab_size, d), torch.bfloat16)]
    return first, second


def write_tokenizer(path, vocab: int) -> bool:
    """A BPE tokenizer trained on ``TOKENIZER_CORPUS`` (Metaspace, as
    LLaMA's; unk 0, bos 1, eos 2, pad "$$" 3), its vocabulary padded with
    filler pieces to ``vocab`` ids (pieces of the model, not added tokens,
    as a real 32000-piece vocabulary), written as ``tokenizer.json`` and
    ``tokenizer_config.json``. False when ``tokenizers`` or
    ``transformers`` does not import."""
    try:
        import transformers  # noqa: F401
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    except ImportError:
        return False
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(TOKENIZER_CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>", "$$"]))
    spec = json.loads(tok.to_str())
    pieces = spec["model"]["vocab"]
    for i in range(len(pieces), vocab):
        pieces[f"\u2581w{i}"] = i
    (path / "tokenizer.json").write_text(json.dumps(spec))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "pad_token": "$$", "model_max_length": 2048}))
    return True


def write_checkpoints(torch, device, root, cfg):
    """The four files at ``cfg``'s widths in the upstream formats: a Vicuna
    HF directory (``config.json``, two bf16 safetensors shards and their
    index, the tokenizer where it can be built), ``eva_vit_g.pth`` (f16,
    BEiT naming, the position table at the 224-px grid of 257 entries),
    the BLIP-2 ``.pth`` and the stage-2 ``.pth``. Returns the paths, the
    kept tensors, the seconds to write each and whether a tokenizer was
    written."""
    lc, vc, qc = cfg.llama, cfg.vit, cfg.qformer
    last_l, last_v, last_q = lc.num_layers - 1, vc.depth - 1, qc.num_layers - 1

    def keep(name):
        """The tensors outside the stacks, and the first and last layer's."""
        import re

        found = re.search(r"(model\.layers|blocks|encoder\.layer)\.(\d+)\.", name)
        if found is None:
            return True
        last = {"model.layers": last_l, "blocks": last_v, "encoder.layer": last_q}[found[1]]
        return int(found[2]) in (0, last)

    w = CheckpointWriter(torch, device, keep)
    paths = {"llama_model": root / "vicuna-7b", "eva_vit_g_pth": root / "eva_vit_g.pth",
             "q_former_model": root / "blip2_pretrained_flant5xxl.pth",
             "ckpt": root / "pretrained_minigpt4.pth"}
    seconds = {}

    t0 = time.perf_counter()
    vicuna = paths["llama_model"]
    vicuna.mkdir()
    (vicuna / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": lc.hidden_size, "intermediate_size": lc.intermediate_size,
        "num_hidden_layers": lc.num_layers, "num_attention_heads": lc.num_heads,
        "num_key_value_heads": lc.num_kv_heads, "vocab_size": lc.vocab_size,
        "max_position_embeddings": 2048, "rms_norm_eps": lc.rms_norm_eps,
        "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"}))
    weight_map, total = {}, 0
    shards = vicuna_specs(torch, lc)
    for k, specs in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(torch, vicuna / name, specs, w.linear)
        weight_map.update({spec[0]: name for spec in specs})
    (vicuna / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    tokenizer = write_tokenizer(vicuna, lc.vocab_size)
    seconds["llama_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    d, grid = vc.embed_dim, 224 // vc.patch_size
    h = torch.float16
    vit = {"patch_embed.proj.weight": w("patch_embed.proj.weight",
                                        (d, vc.in_channels, vc.patch_size, vc.patch_size), h,
                                        std=(vc.in_channels * vc.patch_size ** 2) ** -0.5),
           "patch_embed.proj.bias": w("patch_embed.proj.bias", (d,), h),
           "cls_token": w("cls_token", (1, 1, d), h),
           "pos_embed": w("pos_embed", (1, grid * grid + 1, d), h)}
    for i in range(vc.depth):
        b = f"blocks.{i}."
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.q_bias", (d,)),
                            ("attn.v_bias", (d,)), ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)), ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (vc.mlp_hidden, d)), ("mlp.fc1.bias", (vc.mlp_hidden,)),
                            ("mlp.fc2.weight", (d, vc.mlp_hidden)), ("mlp.fc2.bias", (d,))):
            vit[b + name] = w.linear(b + name, shape, h).cpu()
    torch.save(vit, paths["eva_vit_g_pth"])
    del vit
    seconds["eva_vit_g_pth"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    f32, qd = torch.float32, qc.hidden_size
    bert = {}

    def put(name, shape):
        bert["Qformer.bert." + name] = w.linear(name, shape, f32).cpu()

    def lin(name, d_out, d_in):
        put(name + ".weight", (d_out, d_in))
        put(name + ".bias", (d_out,))

    def ln(name):
        put(name + ".weight", (qd,))
        put(name + ".bias", (qd,))

    put("embeddings.word_embeddings.weight", (30523, qd))
    put("embeddings.position_embeddings.weight", (512, qd))
    ln("embeddings.LayerNorm")
    for i in range(qc.num_layers):
        b = f"encoder.layer.{i}."
        for part in ("query", "key", "value"):
            lin(f"{b}attention.self.{part}", qd, qd)
        lin(b + "attention.output.dense", qd, qd)
        ln(b + "attention.output.LayerNorm")
        if qc.has_cross_attention(i):
            lin(b + "crossattention.self.query", qd, qd)
            lin(b + "crossattention.self.key", qd, qc.encoder_width)
            lin(b + "crossattention.self.value", qd, qc.encoder_width)
            lin(b + "crossattention.output.dense", qd, qd)
            ln(b + "crossattention.output.LayerNorm")
        for branch in ("", "_query"):
            lin(f"{b}intermediate{branch}.dense", qc.intermediate_size, qd)
            lin(f"{b}output{branch}.dense", qd, qc.intermediate_size)
            ln(f"{b}output{branch}.LayerNorm")
    bert["query_tokens"] = w("query_tokens", (1, qc.num_query_tokens, qd), f32).cpu()
    # keys of the other BLIP-2 modules, which the loader's prefix drops
    bert["visual_encoder.cls_token"] = torch.zeros(1, 1, d)
    bert["t5_proj.weight"] = torch.zeros(8, qd)
    bert["t5_proj.bias"] = torch.zeros(8)
    torch.save({"model": bert}, paths["q_former_model"])
    del bert
    seconds["q_former_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.save({"model": {
        "llama_proj.weight": w("llama_proj.weight", (lc.hidden_size, qd), f32, std=qd ** -0.5).cpu(),
        "llama_proj.bias": w("llama_proj.bias", (lc.hidden_size,), f32).cpu(),
        "ln_vision.weight": w("ln_vision.weight", (d,), f32, offset=1.0).cpu(),
        "ln_vision.bias": w("ln_vision.bias", (d,), f32).cpu()}}, paths["ckpt"])
    seconds["ckpt"] = time.perf_counter() - t0
    return {k: str(v) for k, v in paths.items()}, w.kept, seconds, tokenizer


def check_loaded_leaves(torch, params, kept, cfg) -> int:
    """The first and last layer of every stack, the position table, the
    embeddings and heads, ``llama_proj`` and ``ln_vision`` of the loaded
    model equal the written tensors transposed and cast to the model's
    dtypes (int8 stacks: ``quantize_kernel`` of them), bit for bit. Returns
    the number of leaves checked."""
    from certifiedgpt_tpu_torch.models.convert import interpolate_pos_embed
    from certifiedgpt_tpu_torch.ops.quantization import quantize_kernel

    device = params["llama_proj"]["kernel"].device
    checked = []

    def cast(name, dtype, transpose=False):
        t = kept[name].to(device).float()
        return (t.T if transpose else t).to(dtype)

    def same(label, got, want):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            fail(f"phase 12: the loaded {label} ({got.dtype}, {tuple(got.shape)}) is not the "
                 f"written tensor transposed and cast ({want.dtype}, {tuple(want.shape)})")
        checked.append(label)

    def stack(label, tree, i, name, dtype):
        """Layer ``i`` of a stacked dense leaf: its kernel (or int8 codes
        and scales) and its bias where it has one."""
        want = cast(name + ".weight", dtype, transpose=True)
        if "kernel_q" in tree:
            q = quantize_kernel(want)
            same(label + " codes", tree["kernel_q"][i], q["kernel_q"])
            same(label + " scales", tree["scale"][i], q["scale"])
        else:
            same(label, tree["kernel"][i], want)
        if "bias" in tree:
            same(label + " bias", tree["bias"][i], cast(name + ".bias", dtype))

    lc, vc, qc = cfg.llama, cfg.vit, cfg.qformer
    llama, bf = params["llama"], lc.dtype
    for i in (0, lc.num_layers - 1):
        for mod, scope in VICUNA_MODULES.items():
            stack(f"decoder layer {i} {mod}", llama["layers"][mod], i,
                  f"model.layers.{i}.{scope}.{mod}", bf)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            same(f"decoder layer {i} {norm}", llama["layers"][norm]["scale"][i],
                 cast(f"model.layers.{i}.{norm}.weight", bf))
    same("embed_tokens", llama["embed_tokens"]["embedding"], cast("model.embed_tokens.weight", bf))
    same("lm_head", llama["lm_head"]["kernel"], cast("lm_head.weight", bf, transpose=True))
    same("decoder norm", llama["norm"]["scale"], cast("model.norm.weight", bf))

    vit, vt = params["vit"], vc.dtype
    for i in (0, vc.depth - 1):
        for mod, src in VIT_KERNELS.items():
            stack(f"ViT layer {i} {mod}", vit["layers"][mod], i, f"blocks.{i}.{src}", vt)
        for norm in ("norm1", "norm2"):
            same(f"ViT layer {i} {norm}", vit["layers"][norm]["scale"][i],
                 cast(f"blocks.{i}.{norm}.weight", vt))
            same(f"ViT layer {i} {norm} bias", vit["layers"][norm]["bias"][i],
                 cast(f"blocks.{i}.{norm}.bias", vt))
        for bias in ("q_bias", "v_bias"):
            same(f"ViT layer {i} {bias}", vit["layers"][bias][i], cast(f"blocks.{i}.attn.{bias}", vt))
    pos = interpolate_pos_embed(kept["pos_embed"], vc.num_patches)
    same("ViT pos_embed (the 224-px table resampled)", vit["pos_embed"], pos.to(device).to(vt))
    same("ViT cls_token", vit["cls_token"], cast("cls_token", vt))
    conv = kept["patch_embed.proj.weight"].to(device).float()
    same("ViT patch_embed", vit["patch_embed"]["kernel"],
         conv.reshape(conv.shape[0], -1).T.to(vt).contiguous())

    q, qt = params["qformer"], qc.dtype
    same("Q-Former query_tokens", q["query_tokens"], cast("query_tokens", qt))
    same("Q-Former word_embeddings", q["word_embeddings"]["embedding"],
         cast("embeddings.word_embeddings.weight", qt))
    for i in (0, qc.num_layers - 1):
        lp, b = q["layers"][f"layer_{i}"], f"encoder.layer.{i}."
        for leaf, name in (("self_q", "attention.self.query"), ("int_q", "intermediate_query.dense"),
                           ("int_txt", "intermediate.dense"), ("out_txt", "output.dense")):
            same(f"Q-Former layer {i} {leaf}", lp[leaf]["kernel"],
                 cast(f"{b}{name}.weight", qt, transpose=True))
            same(f"Q-Former layer {i} {leaf} bias", lp[leaf]["bias"], cast(f"{b}{name}.bias", qt))
    same("llama_proj kernel", params["llama_proj"]["kernel"],
         cast("llama_proj.weight", torch.float32, transpose=True))
    same("llama_proj bias", params["llama_proj"]["bias"], cast("llama_proj.bias", torch.float32))
    for leaf, name in (("scale", "weight"), ("bias", "bias")):
        same(f"ln_vision {leaf}", params["ln_vision"][leaf],
             cast(f"ln_vision.{name}", params["ln_vision"][leaf].dtype))
    return len(checked)


def phase_checkpoints(torch, card, device, main_summary):
    """Phase 12: write the four checkpoint files at full width (12.1), then
    run ``launch.main`` on the shipped certify YAML, unchanged, over one
    written image with the YAML's checkpoint variables pointing at them
    (12.2): the seconds to load each file, the model build, the peak host
    and device memory of the load, the row and its launches; the loaded
    leaves against the written tensors, and every ``encode_img`` reading
    the stage-2 projection. Returns the run's launches."""
    import resource
    import shutil
    import tempfile
    from pathlib import Path
    from unittest import mock

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.models import model_zoo as Z

    path = LAUNCH_RUNS[0][1]
    knobs = A.SmoothingKnobs.from_run(Config(path).run)
    cfg = Z.config_from_block(CERTIFY_MODEL_BLOCK)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        log(f"[ckpt] 12.1: {free_gb:.1f} GB free on the disk of {tmp}")
        if free_gb < CKPT_DISK_GB:
            fail(f"phase 12: {free_gb:.1f} GB free under {tmp}, the checkpoints need "
                 f"{CKPT_DISK_GB} GB")
        root = Path(tmp)
        t0 = time.perf_counter()
        paths, kept, write_s, tokenizer = write_checkpoints(torch, device, root, cfg)
        sizes = {k: sum(f.stat().st_size for f in Path(p).rglob("*")) if Path(p).is_dir()
                 else Path(p).stat().st_size for k, p in paths.items()}
        log(f"[ckpt] 12.1: wrote {json.dumps({k: round(v / 1e9, 3) for k, v in sizes.items()})} "
            f"GB in {json.dumps({k: round(v, 3) for k, v in write_s.items()})} s "
            f"({time.perf_counter() - t0:.3f} s with the tokenizer: "
            f"{'trained' if tokenizer else 'none, transformers or tokenizers does not import'})")

        (root / "vqa").mkdir()
        write_vqa_set(root / "vqa", CKPT_IMAGES)
        env = {"VQAV2_IMAGES": str(root / "vqa" / "images"),
               "VQAV2_VAL_QUESTIONS": str(root / "vqa" / "questions.json"),
               "VQAV2_VAL_ANNOTATIONS": str(root / "vqa" / "annotations.json"),
               "VQA_FINETUNED": "",  # the projection is the stage-2 file's
               **dict(zip(CHECKPOINT_ENV, (paths["llama_model"], paths["eva_vit_g_pth"],
                                           paths["q_former_model"], paths["ckpt"]))),
               }
        if not tokenizer:
            env["VICUNA_7B"] = str(root / "absent")
            log("[ckpt] 12.2: transformers does not import here, so the Vicuna directory "
                "(which needs its tokenizer) is left out of the YAML's run and loaded through "
                "load_llama_dir for the leaf checks")

        load, models = {}, []

        def timed(fn, key):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                k = key(args) if callable(key) else key
                load[k] = load.get(k, 0.0) + time.perf_counter() - start
                return out
            return wrapper

        file_of = {p: k for k, p in paths.items()}
        from_config = Z.MiniGPT4Model.from_config.__func__

        def build(klass, block, device="cuda"):
            rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            torch.cuda.reset_peak_memory_stats()
            model = from_config(klass, block, device)
            torch.cuda.synchronize()
            load["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
            load["model_gb"] = torch.cuda.memory_allocated() / 1e9
            load["host_rss_gb"] = (rss0, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)
            models.append(model)
            return model

        patches = [
            mock.patch.object(Z.MiniGPT4Model, "from_config", classmethod(build)),
            mock.patch.object(Z, "_torch_load", timed(Z._torch_load,
                                                      lambda a: f"{file_of.get(str(a[0]), a[0])} read")),
            mock.patch.object(Z, "load_llama_dir", timed(Z.load_llama_dir, "llama_model")),
            mock.patch.object(Z, "HFTokenizer", timed(Z.HFTokenizer, "tokenizer")),
            mock.patch.object(Z, "convert_eva_vit_state_dict",
                              timed(Z.convert_eva_vit_state_dict, "eva_vit_g_pth convert")),
            mock.patch.object(Z, "convert_qformer_state_dict",
                              timed(Z.convert_qformer_state_dict, "q_former_model convert")),
            mock.patch.object(Z, "load_projection", timed(Z.load_projection, "ckpt convert")),
        ]
        out = root / "out_certify"
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            res = run_launch(torch, ["certify", "--config-path", path], env, out)
        rows = read_rows(out / "certify_results.jsonl")
        log(f"[ckpt] 12.2 certify {path} from the files: rows {json.dumps(rows)}")
        check_certify_rows("phase 12", rows, "certify", CKPT_IMAGES, knobs.n0 + knobs.n,
                           knobs.sigma)
        if rows[0]["abstain"]:
            fail(f"phase 12: the row abstains: {rows[0]}")
        chunks = dispatched_chunks(rows[0], knobs.n0, knobs.n, knobs.mc_batch,
                                   knobs.dispatch_window)
        proj = {"model:llama_proj/kernel": kept["llama_proj.weight"].T.contiguous().numpy(),
                "model:llama_proj/bias": kept["llama_proj.bias"].numpy()}
        check_projection("phase 12", res["seen"], proj, chunks)
        check_counts("phase 12 certify", res["launches"], PER_CHUNK["flash_cls"], chunks)

        model = models[0]
        params = dict(model.params)
        if not tokenizer:
            params["llama"] = Z.load_llama_dir(paths["llama_model"], cfg.llama, device,
                                               bool(CERTIFY_MODEL_BLOCK["quantize_llama"]))
        checked = check_loaded_leaves(torch, params, kept, cfg)
        del model, models, params
        per_file = {k: round(load.get(f"{k} read", 0.0) + load.get(f"{k} convert", 0.0)
                             + load.get(k, 0.0), 3) for k in paths}
        rss0, rss1 = load["host_rss_gb"]
        log(f"[ckpt] 12.2: seconds to load each file (read + convert + quantize on the card) "
            f"{json.dumps(per_file)}, the tokenizer {load.get('tokenizer', 0.0):.3f} s; model "
            f"build {res['build_s']:.3f} s (certified.log); peak device memory of the load "
            f"{load['peak_device_gb']:.2f} GB for a {load['model_gb']:.2f} GB model; the "
            f"process's peak host RSS {rss0:.2f} GB before the load, {rss1:.2f} GB after; "
            f"{checked} loaded leaves equal the written tensors transposed and cast (int8: "
            f"quantize_kernel of them); every encode_img ({len(res['seen'])}) read the stage-2 "
            f"llama_proj; {card}")
        phase4 = ("phase 4 not run" if main_summary is None else
                  f"phase 4's certify_item on synthetic weights: "
                  f"{main_summary['wall_seconds'] / main_summary['chunks']:.4f} s a chunk")
        log(f"[ckpt] 12.2: {rows[0]['seconds']:.3f} s per certified image from the files over "
            f"{chunks} chunks ({rows[0]['seconds'] / chunks:.4f} s a chunk; {phase4}); "
            f"launches a chunk "
            f"{json.dumps({k: v // chunks for k, v in res['launches'].items()})}; "
            f"{res['decode_steps']} decode steps launched; peak memory {res['peak_gb']:.2f} GB; "
            f"CLI wall {res['wall']:.3f} s; card during the run: {res['card_state']}")
        return res["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 13: the decode modes on the card
# ----------------------------------------------------------------------
# run-block changes of the shipped eval config, one run each
DECODE_RUNS = (("beam search", {"num_beams": 3}),
               ("sampling", {"do_sample": True, "top_p": 0.9, "temperature": 1.0}),
               ("penalty", {"repetition_penalty": 1.2, "min_length": 2}))
DECODE_MIN_LENGTH = 3  # the chain model's rows end at steps 1-5 without it


def check_decode_modes(torch, device, card):
    """Phase 13's direct checks: on the full-width synthetic model of the
    eval config, ``generate_beam`` at one beam gives ``generate``'s greedy
    tokens, and sampling repeats with its seed and differs across seeds; on
    phase 9.2's chain model, no row emits EOS before ``min_length`` (and
    without it a row does at once), and ``generate`` with every knob on and
    the early exit is dispatched without a host sync."""
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    run = Config(EVAL_CONFIG).run
    seq_len, steps = int(run.get("seq_len")), int(run.get("max_new_tokens"))
    model = MiniGPT4Model.from_config(CERTIFY_MODEL_BLOCK, device)
    prompt = build_gen_batch(model.tokenizer, [QUESTION] * EVAL_BATCH,
                             BatchSpec(seq_len=seq_len, num_img_tokens=model.cfg.num_img_tokens))
    g = torch.Generator(device=device)
    g.manual_seed(13)
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in prompt.items()}
    batch["image"] = torch.randn((EVAL_BATCH, *IMAGE_HWC), generator=g, device=device)
    tok = model.tokenizer
    args = (model.params, model.cfg, batch, steps, tok.eos_token_id, tok.pad_token_id)
    greedy = M.generate(*args)
    beam = M.generate_beam(*args, num_beams=1)
    if not torch.equal(beam, greedy):
        fail(f"phase 13: generate_beam at one beam {beam.tolist()} is not greedy {greedy.tolist()}")

    def sample(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return M.generate(*args, do_sample=True, top_p=0.9, temperature=1.0, generator=gen)

    first, again, other = sample(1), sample(1), sample(2)
    if not torch.equal(first, again) or torch.equal(first, other):
        fail("phase 13: sampling does not repeat with its seed, or two seeds drew the same tokens")
    del model, batch, args
    gc.collect()
    torch.cuda.empty_cache()

    chain, batch = chain_model(torch, device)
    eos, pad = 2, 0
    plain = M.generate(chain.params, chain.cfg, batch, EXIT_STEPS, eos, pad).cpu().tolist()
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    knobs = dict(do_sample=True, top_p=0.9, temperature=1.0, repetition_penalty=1.2,
                 min_length=DECODE_MIN_LENGTH, generator=gen, early_exit=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = M.generate(chain.params, chain.cfg, batch, EXIT_STEPS, eos, pad, **knobs)
    except RuntimeError as exc:
        fail(f"phase 13: generate with the decode knobs made the host wait for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = out.cpu().tolist()
    first_eos = [row.index(eos) if eos in row else EXIT_STEPS for row in out]
    if min(first_eos) < DECODE_MIN_LENGTH - 1 or plain[0][0] != eos:
        fail(f"phase 13: EOS before min_length {DECODE_MIN_LENGTH}: {out} (without it: {plain})")
    log(f"[decode] generate_beam at one beam equals greedy on the full-width model "
        f"({EVAL_BATCH} rows x {steps} tokens); sampling (top_p 0.9) repeats with its seed and "
        f"differs across seeds; on the chain model min_length {DECODE_MIN_LENGTH} holds EOS "
        f"back (first EOS at {first_eos}; without it {[r.index(eos) for r in plain]}); "
        f"generate with sampling, the repetition penalty, min_length and the early exit "
        f"dispatched with no sync (set_sync_debug_mode 'error'); {card}")


def phase_decode(torch, card, device, d_in: int, d_out: int):
    """Phase 13: ``launch.main`` in ``eval`` mode on
    ``vqav2_eval_noise_0.5.yaml`` with only its run block changed
    (``DECODE_RUNS``) over phase 10's ten written questions (synthetic
    weights, as phase 10): the JAX package's summary keys, a prediction
    for every question, each batch the path's launches and the stage-2
    or finetuned projection read; then ``check_decode_modes``. Returns the
    launches of each run."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.common.config import Config

    run = Config(EVAL_CONFIG).run
    batches = -(-EVAL_QUESTIONS // int(run.get("batch_size")))
    counted = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, EVAL_QUESTIONS, d_in, d_out)
        for name, knobs in DECODE_RUNS:
            tag = name.replace(" ", "_")
            cfg = config_with_run(EVAL_CONFIG, root / f"eval_{tag}.yaml", **knobs)
            out = root / f"out_{tag}"
            res = run_launch(torch, ["eval", "--config-path", str(cfg)], env, out)
            saved = json.loads((out / "eval_results.json").read_text())
            summary = res["summary"]
            if saved["summary"] != summary or set(summary) != EVAL_SUMMARY_KEYS \
                    or summary["num_questions"] != EVAL_QUESTIONS \
                    or sorted(p["question_id"] for p in saved["predictions"]) \
                    != list(range(1, EVAL_QUESTIONS + 1)):
                fail(f"phase 13 {name}: results {saved} do not have the JAX package's keys")
            check_projection(f"phase 13 {name}", res["seen"], proj, batches)
            check_counts(f"phase 13 {name}", res["launches"], PER_CHUNK["flash_cls"], batches)
            log(f"[decode] eval {EVAL_CONFIG} with {json.dumps(knobs)}: "
                f"{res['wall'] - res['build_s']:.3f} s over the agent's run ({EVAL_QUESTIONS} "
                f"questions in {batches} batches), CLI wall {res['wall']:.3f} s; "
                f"{res['decode_steps']} generate decode steps launched; peak memory "
                f"{res['peak_gb']:.2f} GB; launches {json.dumps(res['launches'])}; first "
                f"predictions {json.dumps(saved['predictions'][:2])}; {card}")
            counted[f"eval {name}"] = res["launches"]
            gc.collect()
            torch.cuda.empty_cache()
    check_decode_modes(torch, device, card)
    return counted


# ----------------------------------------------------------------------
# phase 14: the attack stage on the shipped attack config
# ----------------------------------------------------------------------
ATTACK_CONFIG = "configs/attack_configs/vqav2_attack.yaml"
ATTACK_IMAGES = 2  # the written set caps the YAML's max_images
# the YAML's backbones (and its run.attack_backbones order)
ATTACK_BACKBONES = ("rn50", "rn101", "vit_b16", "vit_b32", "vit_l14")
ATTACK_SEED = 14
ATTACK_TIMED_STEPS = 10  # PGD steps timed per backbone in 14.2
# 14.2, each surrogate on the card against the CPU (f32 both): relative
# (Frobenius) error of one image's embedding, share of the loss gradient's
# signs that agree
SURROGATE_EMBED_REL_LIMIT = 1e-4
SURROGATE_SIGN_SHARE = 0.99
# 14.3: the caption's first-step logits through the kernels may move from the
# plain versions' at most this many times as far as a random change of the
# plain image tokens by as much as the kernels changed them
CAPTION_LOGIT_FACTOR = 2.0
ATTACK_ROW_KEYS = {"index", "question_id", "backbone", "sigma", "target_text", "clean_caption",
                   "adv_caption", "clean_similarity", "adv_similarity", "similarity",
                   "success", "linf"}
ATTACK_SUMMARY_KEYS = {"total", "sigma_grid", "epsilon", "steps", "success_rate_per_backbone",
                       "overall_success_rate", "success_rate_grid", "ancova"}
CLIP_VIT_B32 = {"hidden": 768, "layers": 12, "inter": 3072, "patch": 32, "positions": 50,
                "proj": 512, "text_hidden": 512, "text_layers": 12, "text_inter": 2048,
                "vocab": 49408, "text_positions": 77}


def phase_attack_kernels(torch, device):
    """14.1: the three kernels of a victim caption at batch 1 against their
    plain versions, within phase 3's limits: the cls-split kernel with 16
    (b, h) pairs, the row-quant kernels at the patch stream's 1024 rows and
    the cls stream's one."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    ln_args, gelu_args = row_quant_args(torch, device, ATTACK_SEED)
    rows = (VIT_TOKENS, 1)  # one image's patch stream, its cls stream
    return {
        "cls_split_attention": check_cls_split(torch, device, b=1),
        "ln_quant_rows": check_row_quant(
            torch, "ln_quant_rows", Q.ln_quant_rows, [(Q._ln_quant_rows_plain, *ROW_QUANT_TIGHT)],
            [(m, VIT_WIDTH) for m in rows], LN_QUANT_OPS_PER_ELEM, ln_args),
        "gelu_quant_rows": check_row_quant(
            torch, "gelu_quant_rows", Q.gelu_quant_rows,
            [(Q._gelu_quant_rows_as_plain, *ROW_QUANT_TIGHT),
             (Q._gelu_quant_rows_plain, *ROW_QUANT_EXACT_ERF)],
            [(m, VIT_MLP) for m in rows], GELU_QUANT_OPS_PER_ELEM, gelu_args),
    }


def tree_to(tree, device):
    """A copy of a nested dict/list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def phase_attack_surrogates(torch, card, device):
    """14.2: each of the YAML's five surrogates at full width, seeded on the
    card as the agent seeds them: one 448-px image's embedding on the card
    against the CPU's (same weights), the gradient of the loss toward a
    target image's embedding on both (the share of signs that agree), the
    card's milliseconds a PGD step (forward + backward, resize and
    normalization included) and the peak memory with all five resident."""
    import numpy as np

    from certifiedgpt_tpu_torch.attack import agent as AG
    from certifiedgpt_tpu_torch.attack import attack as AT

    rng = np.random.RandomState(ATTACK_SEED)
    x_cpu = torch.from_numpy(rng.rand(1, *IMAGE_HWC).astype(np.float32))
    t_cpu = torch.from_numpy(rng.rand(1, *IMAGE_HWC).astype(np.float32))
    x, target = x_cpu.to(device), t_cpu.to(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    per_step, kept = {}, []
    for i, name in enumerate(ATTACK_BACKBONES):
        cfg, apply_fn, init_fn = AG._BACKBONES[name]()
        params = init_fn(1000 + i, cfg, device)
        size = getattr(cfg, "image_size", None) or cfg.img_size
        enc = AT.SurrogateEncoder(name, lambda p, imgs, f=apply_fn, c=cfg: f(p, c, imgs),
                                  params, size)
        cpu_params = tree_to(params, "cpu")
        n_params = tree_numel(params)
        emb = AT.embed_images([enc], {name: params}, x)[name]
        emb_cpu = AT.embed_images([enc], {name: cpu_params}, x_cpu)[name]
        tgt = AT.embed_images([enc], {name: params}, target)
        tgt_cpu = AT.embed_images([enc], {name: cpu_params}, t_cpu)
        grads = []
        for px, p, tg in ((x, params, tgt), (x_cpu, cpu_params, tgt_cpu)):
            with AT.exact_f32(), torch.enable_grad():
                xg = px.clone().requires_grad_(True)
                (grad,) = torch.autograd.grad(AT.ensemble_loss([enc], xg, {name: p}, tg), xg)
            grads.append(grad)
        erel = rel_err(emb.cpu(), emb_cpu)
        share = float((torch.sign(grads[0].cpu()) == torch.sign(grads[1])).float().mean())
        attack = AT.make_pgd_attack([enc], 8.0 / 255.0, 1.0 / 255.0, ATTACK_TIMED_STEPS)
        ms = cuda_ms(torch, lambda: attack({name: params}, x, tgt), iters=1, warmup=1)
        per_step[name] = ms / ATTACK_TIMED_STEPS
        # the same steps on four images at once: a step that takes about as
        # long is bound by its launches, not by the card's work
        x4 = x.expand(4, -1, -1, -1).contiguous()
        tgt4 = {name: tgt[name].expand(4, -1).contiguous()}
        ms4 = cuda_ms(torch, lambda: attack({name: params}, x4, tgt4), iters=1, warmup=1)
        log(f"[attack] 14.2 {name}: {n_params / 1e6:.1f} M f32 parameters at {size} px; "
            f"embedding on the card vs the CPU: relative error {erel:.3e}; loss gradient signs "
            f"agreeing {share:.6f}; {per_step[name]:.3f} ms a PGD step (forward + backward, "
            f"{ATTACK_TIMED_STEPS} steps timed), {ms4 / ATTACK_TIMED_STEPS:.3f} ms a step "
            f"on 4 images")
        if not erel < SURROGATE_EMBED_REL_LIMIT or not share >= SURROGATE_SIGN_SHARE \
                or not bool(torch.isfinite(grads[0]).all()):
            fail(f"14.2 {name}: the card's surrogate disagrees with the CPU's "
                 f"(embedding {erel:.3e}, signs {share:.6f})")
        kept.append(params)
        del cpu_params, emb_cpu, tgt_cpu, grads
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    xr = x.clone().requires_grad_(True)

    def resize_step():
        with torch.enable_grad():
            torch.autograd.grad(AT._normalize(AT._resize(xr, 224)).sum(), xr)

    log(f"[attack] 14.2: the 448 -> 224 resize and normalization, forward + backward: "
        f"{cuda_ms(torch, resize_step, iters=20):.4f} ms a step")
    log(f"[attack] 14.2: ms a PGD step {json.dumps({k: round(v, 4) for k, v in per_step.items()})}; "
        f"the five surrogates {(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB resident, "
        f"peak {peak:.2f} GB over them; {card}")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return per_step


def clip_tokenizer_files(path) -> int:
    """A CLIP BPE tokenizer with no merges (``vocab.json``, ``merges.txt``,
    ``tokenizer_config.json``): the 256 byte characters, the same with
    ``</w>``, then ``<|startoftext|>`` and ``<|endoftext|>`` (pad = EOT = the
    highest id, so the text tower pools at the first EOT). Returns its size."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    extra = [b for b in range(256) if b not in bs]
    chars = [chr(c) for c in bs] + [chr(256 + n) for n in range(len(extra))]
    vocab = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (path / "merges.txt").write_text("#version: 0.2\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>",
        "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
        "pad_token": "<|endoftext|>", "model_max_length": 77}))
    return len(vocab)


class SeededTensors:
    """Seeded f32 tensors drawn on the card, by name: norm weights 1 + noise,
    matrices std 1/sqrt(fan-in), anything else std 0.02; ``kept`` holds the
    host copies of the names ``keep`` lists."""

    def __init__(self, torch, device, seed, keep=()):
        self.torch, self.device, self.keep = torch, device, set(keep)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.kept = {}

    def __call__(self, name, shape, dtype=None):
        torch = self.torch
        t = torch.randn(shape, generator=self.gen, device=self.device)
        if name.endswith("weight") and any(n in name for n in ("norm", ".bn", "downsample.1")):
            t = 1.0 + 0.02 * t
        elif name.endswith("running_var"):
            t = 1.0 + 0.1 * t.abs()
        elif len(shape) >= 2 and "embedding" not in name:
            t = t * math.prod(shape[1:]) ** -0.5
        else:
            t = t * 0.02
        if name in self.keep:
            self.kept[name] = t.cpu()
        return t


def write_clip_dir(torch, device, path):
    """A full-width HF ViT-B/32 CLIP directory from a seed: ``config.json``
    (the vision block's patch; the text block left to CLIP's defaults),
    ``model.safetensors`` (f32, ``CLIPModel``'s keys, written by
    ``write_safetensors``) and the synthesized tokenizer. Returns the
    seeded tensors (with the kept ones)."""
    c = CLIP_VIT_B32
    path.mkdir()
    specs = [("logit_scale", (), torch.float32)]

    def tower(prefix, d, inter, layers):
        for i in range(layers):
            p = f"{prefix}.encoder.layers.{i}."
            for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
                specs.extend([(p + f"self_attn.{m}.weight", (d, d), torch.float32),
                              (p + f"self_attn.{m}.bias", (d,), torch.float32)])
            specs.extend([(p + "mlp.fc1.weight", (inter, d), torch.float32),
                          (p + "mlp.fc1.bias", (inter,), torch.float32),
                          (p + "mlp.fc2.weight", (d, inter), torch.float32),
                          (p + "mlp.fc2.bias", (d,), torch.float32)])
            for n in ("layer_norm1", "layer_norm2"):
                specs.extend([(p + f"{n}.weight", (d,), torch.float32),
                              (p + f"{n}.bias", (d,), torch.float32)])

    d, td = c["hidden"], c["text_hidden"]
    specs += [("vision_model.embeddings.class_embedding", (d,), torch.float32),
              ("vision_model.embeddings.patch_embedding.weight", (d, 3, c["patch"], c["patch"]),
               torch.float32),
              ("vision_model.embeddings.position_embedding.weight", (c["positions"], d),
               torch.float32)]
    for n in ("pre_layrnorm", "post_layernorm"):
        specs += [(f"vision_model.{n}.weight", (d,), torch.float32),
                  (f"vision_model.{n}.bias", (d,), torch.float32)]
    tower("vision_model", d, c["inter"], c["layers"])
    specs += [("visual_projection.weight", (c["proj"], d), torch.float32),
              ("text_model.embeddings.token_embedding.weight", (c["vocab"], td), torch.float32),
              ("text_model.embeddings.position_embedding.weight", (c["text_positions"], td),
               torch.float32),
              ("text_model.final_layer_norm.weight", (td,), torch.float32),
              ("text_model.final_layer_norm.bias", (td,), torch.float32),
              ("text_projection.weight", (c["proj"], td), torch.float32)]
    tower("text_model", td, c["text_inter"], c["text_layers"])
    make = SeededTensors(torch, device, ATTACK_SEED, keep=(
        "visual_projection.weight", "vision_model.encoder.layers.11.mlp.fc2.weight",
        "text_projection.weight"))
    size = write_safetensors(torch, path / "model.safetensors", specs,
                             lambda name, shape, dtype: make(name, shape))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": c["proj"],
        "text_config": {}, "vision_config": {"patch_size": c["patch"]}}))
    vocab = clip_tokenizer_files(path)
    log(f"[attack] 14.3: wrote {path.name}: model.safetensors {size / 1e9:.3f} GB "
        f"({len(specs)} tensors), config.json, a CLIP tokenizer of {vocab} ids")
    return make


def openai_resnet_shapes(cfg):
    """(key, shape) of every tensor of an OpenAI CLIP ``visual.*`` ResNet
    state dict at ``cfg``'s widths (``torch.save`` of its
    ``ModifiedResNet``: convs, BatchNorm with running statistics and
    ``num_batches_tracked`` (shape None), the attention pool)."""
    shapes = []

    def conv(key, cout, cin, k):
        shapes.append((key + ".weight", (cout, cin, k, k)))

    def bn(key, ch):
        shapes.extend((f"{key}.{leaf}", (ch,))
                      for leaf in ("weight", "bias", "running_mean", "running_var"))
        shapes.append((key + ".num_batches_tracked", None))

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv(f"visual.conv{i}", cout, cin, 3)
        bn(f"visual.bn{i}", cout)
    cin = w
    for stage, blocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        for b in range(blocks):
            base = f"visual.layer{stage + 1}.{b}"
            conv(base + ".conv1", planes, cin, 1)
            bn(base + ".bn1", planes)
            conv(base + ".conv2", planes, planes, 3)
            bn(base + ".bn2", planes)
            conv(base + ".conv3", planes * 4, planes, 1)
            bn(base + ".bn3", planes * 4)
            if b == 0:  # stride 2, or the first stage's change of width
                conv(base + ".downsample.0", planes * 4, cin, 1)
                bn(base + ".downsample.1", planes * 4)
            cin = planes * 4
    embed = w * 32
    shapes.append(("visual.attnpool.positional_embedding",
                   ((cfg.image_size // 32) ** 2 + 1, embed)))
    for proj, out in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                      ("c_proj", cfg.embed_dim)):
        shapes += [(f"visual.attnpool.{proj}.weight", (out, embed)),
                   (f"visual.attnpool.{proj}.bias", (out,))]
    return shapes


def write_rn50(torch, device, path):
    """``RN50.pt`` in the OpenAI ``visual.*`` layout from a seed (a plain
    ``torch.save`` state dict at RN50's widths). Returns the seeded
    tensors."""
    from certifiedgpt_tpu_torch.attack.clip import ClipResNetConfig

    make = SeededTensors(torch, device, ATTACK_SEED + 1, keep=(
        "visual.attnpool.c_proj.weight", "visual.layer3.5.conv2.weight",
        "visual.layer4.0.downsample.1.running_var"))
    sd = {key: torch.tensor(0) if shape is None else make(key, shape).cpu()
          for key, shape in openai_resnet_shapes(ClipResNetConfig.rn50())}
    torch.save(sd, path)
    log(f"[attack] 14.3: wrote {path.name}: {len(sd)} tensors, "
        f"{os.path.getsize(path) / 1e6:.1f} MB")
    return make


def check_loaded_surrogates(torch, agent, clip_made, rn_made, clip_dir, rn_path, log_text):
    """The ViT-B/32 surrogate and RN50 hold the written tensors (transposed
    and permuted to the JAX layout) bit for bit; the text scorer is the CLIP
    tower; the log names each load."""
    from certifiedgpt_tpu_torch.attack import agent as AG

    enc = {e.name: e.params for e in agent.encoders}
    vit, rn = enc["vit_b32"], enc["rn50"]
    k = clip_made.kept
    pairs = [(vit["proj"], k["visual_projection.weight"].T),
             (vit["layers"][11]["fc2"]["kernel"], k["vision_model.encoder.layers.11.mlp.fc2.weight"].T)]
    k = rn_made.kept
    pairs += [(rn["attnpool"]["proj"]["kernel"], k["visual.attnpool.c_proj.weight"].T),
              (rn["layer3"][5]["conv2"]["kernel"], k["visual.layer3.5.conv2.weight"].permute(2, 3, 1, 0)),
              (rn["layer4"][0]["downsample"]["bn"]["var"], k["visual.layer4.0.downsample.1.running_var"])]
    for got, want in pairs:
        if not torch.equal(got.cpu(), want.contiguous()):
            fail("14.3: a loaded surrogate leaf differs from the written tensor")
    if isinstance(agent.text_encoder, AG._HashTextEncoder):
        fail("14.3: the CLIP text encoder did not load from the written directory")
    for line in (f"Loaded vit_b32 weights from {clip_dir}", f"Loaded rn50 weights from {rn_path}",
                 f"CLIP text encoder loaded from {clip_dir}"):
        if line not in log_text:
            fail(f"14.3: certified.log lacks {line!r}")
    for name in ("rn101", "vit_b16", "vit_l14"):
        if f"attack backbone {name} is running on RANDOM weights" not in log_text:
            fail(f"14.3: no random-weights warning for {name}")
    return len(pairs)


def check_attack_outputs(label, out, rows, summary, n_rows, backbones, sigmas, epsilon):
    if len(rows) != n_rows or any(set(r) != ATTACK_ROW_KEYS for r in rows):
        fail(f"{label}: {len(rows)} rows, not {n_rows} with the JAX package's keys")
    for row in rows:
        if not 0.0 <= row["linf"] <= epsilon + 1e-6 or row["sigma"] not in sigmas \
                or row["backbone"] not in backbones \
                or not all(math.isfinite(row[k]) for k in ("clean_similarity", "adv_similarity")):
            fail(f"{label}: malformed row {row}")
    on_disk = json.loads((out / "attack_summary.json").read_text())
    if json.dumps(on_disk, sort_keys=True) != json.dumps(summary, sort_keys=True) \
            or summary["total"] != n_rows \
            or set(summary["success_rate_per_backbone"]) != set(backbones):
        fail(f"{label}: summary {summary} does not match its rows")
    csv_rows = (out / "attack_ancova.csv").read_text().splitlines()
    if len(csv_rows) != n_rows + 1:
        fail(f"{label}: attack_ancova.csv has {len(csv_rows)} lines")


def phase_attack(torch, card, device, d_in: int, d_out: int):
    """14.3: ``launch.main`` in ``attack`` mode on ``vqav2_attack.yaml``
    unchanged over ``ATTACK_IMAGES`` written images (full-width W8A8
    victim from its seed, 100 PGD steps for each of five backbones, four
    sigmas), ``CLIP_HF_DIR``/``CLIP_VIT_B32`` at a written full-width
    ViT-B/32 directory and ``CLIP_RN50`` at a written ``RN50.pt``, the other
    checkpoint variables where nothing exists. 14.4: a copy whose run block
    has one backbone (vit_b32), sigma 0.5 and the RGF stage (2 queries, 1
    iteration) over one image. Checks rows, files, the loads, the launches
    a caption and the caption streams; prints seconds per attacked image
    split into each backbone's PGD and the captions. Returns 14.3's
    launches."""
    import tempfile
    from pathlib import Path
    from unittest import mock

    from certifiedgpt_tpu_torch.attack import agent as AG
    from certifiedgpt_tpu_torch.common.config import Config

    model_block = Config(ATTACK_CONFIG).to_dict()["model"]
    if {k: model_block.get(k) for k in CERTIFY_MODEL_BLOCK} != CERTIFY_MODEL_BLOCK:
        fail(f"{ATTACK_CONFIG}: the model block is not the certify configs' ({model_block})")
    run_cfg = Config(ATTACK_CONFIG).run
    sigmas = [float(s) for s in run_cfg.get("sigma_grid")]
    epsilon = float(run_cfg.get("attack_epsilon"))
    backbones = list(run_cfg.get("attack_backbones"))
    if tuple(backbones) != ATTACK_BACKBONES:
        fail(f"{ATTACK_CONFIG} names backbones {backbones}, not {ATTACK_BACKBONES}")
    timing = {"pgd": {}, "caption": [], "streams": [], "agents": []}
    transfer, caption, run = (AG.AttackAgent._transfer_attack, AG.AttackAgent.caption,
                              AG.AttackAgent.run)

    def timed_transfer(self, attack, pixels, target_pixels, enc):
        t0 = time.perf_counter()
        out = transfer(self, attack, pixels, target_pixels, enc)  # numpy: synchronized
        timing["pgd"].setdefault(enc.name, []).append(time.perf_counter() - t0)
        return out

    def timed_caption(self, pixels, instruction, stream, sigma=None):
        t0 = time.perf_counter()
        out = caption(self, pixels, instruction, stream, sigma)  # a string: synchronized
        timing["caption"].append(time.perf_counter() - t0)
        timing["streams"].append(tuple(stream))
        return out

    def timed_run(self):
        timing["agents"].append(self)
        t0 = time.perf_counter()
        out = run(self)
        timing["run_s"] = time.perf_counter() - t0
        return out

    patches = [mock.patch.object(AG.AttackAgent, "_transfer_attack", timed_transfer),
               mock.patch.object(AG.AttackAgent, "caption", timed_caption),
               mock.patch.object(AG.AttackAgent, "run", timed_run)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_attack_") as tmp, \
            contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        root = Path(tmp)
        env, proj = launch_files(root, ATTACK_IMAGES, d_in, d_out)
        t0 = time.perf_counter()
        clip_dir, rn_path = root / "clip-vit-base-patch32", root / "RN50.pt"
        clip_made = write_clip_dir(torch, device, clip_dir)
        rn_made = write_rn50(torch, device, rn_path)
        log(f"[attack] 14.3: the two surrogate files written in {time.perf_counter() - t0:.3f} s")
        env.update({"CLIP_HF_DIR": str(clip_dir), "CLIP_VIT_B32": str(clip_dir),
                    "CLIP_RN50": str(rn_path),
                    **{k: str(root / "absent" / k.lower())
                       for k in ("CLIP_VIT_B16", "CLIP_VIT_L14", "CLIP_RN101")}})
        out = root / "out_attack"
        res = run_launch(torch, ["attack", "--config-path", ATTACK_CONFIG], env, out)
        rows = read_rows(out / "attack_results.jsonl")
        summary = res["summary"]
        n_rows = ATTACK_IMAGES * len(backbones) * len(sigmas)
        check_attack_outputs("14.3", out, rows, summary, n_rows, backbones, sigmas, epsilon)
        grid = summary.get("success_rate_grid", {})
        if set(summary) != ATTACK_SUMMARY_KEYS or set(grid) != set(backbones) \
                or any(set(cells) != {str(s) for s in sigmas} or None in cells.values()
                       for cells in grid.values()) \
                or len(summary["ancova"]["coefficients"]) != 2 + 2 * (len(backbones) - 1):
            fail(f"14.3: summary {summary} lacks the grid or the ANCOVA")
        if max(r["linf"] for r in rows) < epsilon - 1.5 / 255:
            fail("14.3: the PGD did not reach the l-inf budget")
        captions = ATTACK_IMAGES * len(sigmas) * (1 + len(backbones))
        if len(timing["caption"]) != captions:
            fail(f"14.3: {len(timing['caption'])} captions, expected {captions}")
        check_projection("14.3", res["seen"], proj, captions)
        check_counts("launch attack", res["launches"], PER_CHUNK["flash_cls"], captions)
        pgd = {name: sum(v) / ATTACK_IMAGES for name, v in timing["pgd"].items()}
        cap_s = sum(timing["caption"]) / ATTACK_IMAGES
        per_image = timing["run_s"] / ATTACK_IMAGES
        log_text = (out / "certified.log").read_text()
        loaded = check_loaded_surrogates(torch, timing["agents"][0], clip_made, rn_made,
                                         clip_dir, rn_path, log_text)
        log(f"[attack] 14.3 {ATTACK_CONFIG}: {len(rows)} rows, linf max "
            f"{max(r['linf'] for r in rows) * 255:.3f}/255; success_rate_grid "
            f"{json.dumps(grid)}; ancova sigma {json.dumps(summary['ancova']['coefficients']['sigma'])}; "
            f"{loaded} loaded leaves equal the written tensors; launches "
            f"{json.dumps(res['launches'])} over {captions} captions")
        log(f"[attack] 14.3: {per_image:.3f} s per attacked image (the agent's run "
            f"{timing['run_s']:.3f} s over {ATTACK_IMAGES} images): PGD "
            f"{json.dumps({k: round(v, 3) for k, v in pgd.items()})} s "
            f"({sum(pgd.values()):.3f} s, {len(backbones)} x {int(run_cfg.get('attack_steps'))} "
            f"steps), {captions // ATTACK_IMAGES} captions {cap_s:.3f} s "
            f"({cap_s * ATTACK_IMAGES / captions:.4f} s a caption), other "
            f"{per_image - sum(pgd.values()) - cap_s:.3f} s; model build {res['build_s']:.3f} s, "
            f"CLI wall {res['wall']:.3f} s; {res['decode_steps']} decode steps launched; peak "
            f"memory {res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
        check_caption_kernels(torch, card, timing["agents"][0])
        counted = res["launches"]
        del res
        timing.update(pgd={}, caption=[], streams=[], agents=[])
        gc.collect()
        torch.cuda.empty_cache()

        # 14.4: the RGF query stage on the card
        cfg = config_with_run(ATTACK_CONFIG, root / "attack_rgf.yaml", attack_backbones=["vit_b32"],
                              sigma_grid=[0.5], rgf_queries=2, rgf_iters=1, max_images=1)
        out = root / "out_rgf"
        res = run_launch(torch, ["attack", "--config-path", str(cfg)], env, out)
        rows = read_rows(out / "attack_results.jsonl")
        check_attack_outputs("14.4", out, rows, res["summary"], 1, ["vit_b32"], [0.5], epsilon)
        want = [(0, 0), (2, 0, 0, 0, 1), (2, 0, 0, 0, 2), (2, 0, 0, 0, 3), (1, 0, 0)]
        if timing["streams"] != want:
            fail(f"14.4: caption streams {timing['streams']}, expected {want}")
        check_counts("launch attack rgf", res["launches"], PER_CHUNK["flash_cls"], len(want))
        log(f"[attack] 14.4 RGF (vit_b32, sigma 0.5, 2 queries, 1 iteration): row "
            f"{json.dumps(rows[0])}; {len(want)} captions {sum(timing['caption']):.3f} s, PGD "
            f"{sum(timing['pgd']['vit_b32']):.3f} s, the agent's run {timing['run_s']:.3f} s; "
            f"launches {json.dumps(res['launches'])}; {card}")
        del res, timing["agents"]
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def check_caption_kernels(torch, card, agent):
    """14.3 (end), on 14.3's agent (the full-width W8A8 victim): one caption
    at batch 1 through the kernels and through their plain versions on the
    same seeded pixels and noise stream. The image tokens must agree within
    the attention's relative limit, and the first decode step's logits must
    move from the plain path's by at most ``CAPTION_LOGIT_FACTOR`` times
    what a random change of the plain image tokens of the same size moves
    them (the random-weight W8A8 decoder turns a 1 % change of its input
    into different greedy tokens, as phase 11 found, so token equality is
    held only on the tiny model, ``tests/test_torch_attack_gpu.py``). The
    kernels must run once a layer a ViT forward (39 / 156 / 78)."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.attack.attack import _resize
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.llama import lm_head_logits

    rng = np.random.RandomState(ATTACK_SEED)
    pixels = rng.rand(*IMAGE_HWC).astype(np.float32)
    params, cfg, device = agent.model.params, agent.model.cfg, agent.device
    mean, std = agent._pixel_stats()
    image = _resize(torch.from_numpy((pixels - mean) / std)[None].to(device), cfg.vit.img_size)
    prompt = build_gen_batch(agent.model.tokenizer, [QUESTION],
                             BatchSpec(seq_len=agent.seq_len, num_img_tokens=cfg.num_img_tokens))
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in prompt.items()}
    batch["image"] = image
    victim = agent._victim_generate
    tokens = []

    def recording(*args):
        out = victim(*args)
        tokens.append(out.cpu())
        return out

    def first_logits(feats):
        with mock.patch.object(M, "encode_img", lambda *a, **k: feats):
            return lm_head_logits(params["llama"], M.prefill(params, cfg, batch, 1)[0])

    agent._victim_generate = recording
    try:
        with torch.no_grad():
            reset_counts()
            agent.caption(pixels, QUESTION, (0, 0), 0.5)
            torch.cuda.synchronize()
            launches = read_counts()
            feats = M.encode_img(params, cfg, image)
            with contextlib.ExitStack() as stack:
                for p in plain_versions():
                    stack.enter_context(p)
                agent.caption(pixels, QUESTION, (0, 0), 0.5)
                plain = M.encode_img(params, cfg, image)
                noise = torch.randn(plain.shape, generator=torch.Generator(device=device)
                                    .manual_seed(ATTACK_SEED), device=device)
                control = plain + (noise * (feats - plain).float().norm() / noise.norm()).to(
                    plain.dtype)
                logits = [first_logits(f) for f in (feats, plain, control)]
    finally:
        agent._victim_generate = victim
    err = rel_err(feats, plain)
    dev_k, dev_c = rel_err(logits[0], logits[1]), rel_err(logits[2], logits[1])
    same = [int(a != b) for a, b in zip(tokens[0][0].tolist(), tokens[1][0].tolist())]
    log(f"[attack] 14.3 a caption at batch 1 (full width, W8A8, sigma 0.5) through the kernels "
        f"vs their plain versions: image tokens relative error {err:.3e}; first-step logits "
        f"{dev_k:.3e} apart (a random change of the plain image tokens as large: {dev_c:.3e}); "
        f"greedy tokens {tokens[0][0].tolist()} vs {tokens[1][0].tolist()} ({sum(same)} of "
        f"{len(same)} differ); launches {json.dumps(launches)}; {card}")
    check_counts("14.3 caption", launches, PER_CHUNK["flash_cls"], 1)
    if not err < ATTN_REL_LIMIT or not dev_k <= CAPTION_LOGIT_FACTOR * dev_c:
        fail("14.3: the caption through the kernels disagrees with the plain versions'")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    try:
        import certifiedgpt_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"certifiedgpt_tpu_torch is not importable ({exc}); run from the repository root")

    card = phase_device(torch)
    device = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        records = phase_kernels(torch, device)
        if sys.argv[1:] == ["--kernels"]:  # phases 1-3 only, for work on a kernel
            print(json.dumps({"kernel_phase": records}), flush=True)
            return 0
        model, image, main_launches, summary = phase_main_path(torch, device)
        flash_launches = phase_forms(torch, model, image, device)
        entry_launches = phase_entries(torch, device)
        # 9.1 and 9.2 run on phase 4's model, before the launcher phases
        # build their own
        lookahead = phase_lookahead(torch, model, image, card, summary)
        widths = (model.cfg.qformer.hidden_size, model.cfg.llama.hidden_size)
        del model, image
        gc.collect()
        torch.cuda.empty_cache()
        cli_launches, serial_rows = phase_launcher(torch, card, *widths, summary)
        cli_launches["certify continuous"] = phase_continuous(torch, card, *widths, serial_rows)
        cli_launches["eval"] = phase_eval(torch, card, *widths)
    # phase 11 trains: autograd on
    cli_launches.update(phase_train(torch, card, device, *widths))
    with torch.no_grad():
        t0 = time.perf_counter()
        cli_launches["certify from checkpoints"] = phase_checkpoints(torch, card, device, summary)
        t1 = time.perf_counter()
        cli_launches.update(phase_decode(torch, card, device, *widths))
        log(f"[main] phase 12 took {t1 - t0:.1f} s, phase 13 {time.perf_counter() - t1:.1f} s")
    # phase 14: the attack stage (its PGD turns autograd on for itself)
    t0 = time.perf_counter()
    with torch.no_grad():
        batch1 = phase_attack_kernels(torch, device)
    phase_attack_surrogates(torch, card, device)
    cli_launches["attack"] = phase_attack(torch, card, device, *widths)
    log(f"[main] phase 14 took {time.perf_counter() - t0:.1f} s")
    for name, rec in batch1.items():
        records[name]["attack_batch1"] = {k: rec[k] for k in (
            "ms", "ms_cls", "plain_ms", "bound_ms", "bound_by", "max_abs_err") if k in rec}
    summary["lookahead"] = lookahead
    log(f"[main] summary {json.dumps(summary)}")
    by_path = {"certify flash_cls": main_launches, "certify flash_custom": flash_launches}
    kernels = []
    for name, source, replaces, path in KERNELS:
        rec = records[name]
        n = by_path[path][name] if path in by_path else entry_launches[name]
        lib_ms = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.3f} ms"
        log(f"[kernel] {name}: {rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.3f} ms, library {lib_ms}; "
            f"{n} launches on its path ({path}); through the launcher "
            f"{json.dumps({m: c[name] for m, c in cli_launches.items()})}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "cli_launches": {m: c[name] for m, c in cli_launches.items()},
                        **rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
