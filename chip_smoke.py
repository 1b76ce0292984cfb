#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``certifiedgpt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. Device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off for float32 matmuls and convolutions.
2. Build: compiles the CUDA kernels from ``certifiedgpt_tpu_torch/csrc/``
   (``nvcc``, sm_90a) and prints the build seconds and ptxas' summary.
3. Kernels: calls each kernel's wrapper at the main path's shapes, holds the
   result against its plain PyTorch version on the same card, and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (CUDA events). Tolerances: int8 codes equal except
   +-1 on at most 0.1 % of elements and row scales within rtol 1e-2;
   attention within atol 2e-2 (bf16).
4. Main path: builds MiniGPT-4 at full width (EVA ViT-g/14 at 448 px with 39
   layers, the 12-layer Q-Former, a 32-layer 4096-wide Vicuna-7B-shaped
   decoder) from seeded synthetic weights at the serving layout of
   ``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` (int8 ViT and
   decoder kernels, W8A8 activations, int8 KV cache, cls-split attention,
   early exit) and certifies one seeded synthetic 448x448 image with
   n0 = 100, n = 1000, sigma = 0.5, mc_batch = 96 through
   ``agents.certify.certify_item``, after one warm-up certification of a
   single chunk each way. The kernels' launch counters are reset just before
   and read just after; each must be > 0 (and equal to its launches per chunk
   times the chunks run). Prints per-stage seconds, peak device memory and
   the certify row, and checks the row. Then times one decode step against
   converting the int8 decoder weights to bf16, and checks the outputs: the
   ViT through the kernels against the ViT through their plain versions on
   8 images (a cls stream below the 17 rows ``torch._int_mm`` takes), finite
   projected image tokens, greedy tokens in range.
5. Profile: the warm-up's certification (one chunk each way) once more
   without and once under ``torch.profiler``; prints the device time summed
   by kernel group and the top kernels against the call's wall time.

Prints one JSON line ``{"kernels": [...]}`` with every kernel's numbers, and
as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations per element counted for the row-quant bounds (LayerNorm:
# two reductions, centre, scale, affine, round, absmax, divide, rint, clip;
# GELU: ~15 for erf plus the same quantization tail)
LN_QUANT_OPS_PER_ELEM = 12
GELU_QUANT_OPS_PER_ELEM = 25

# main-path shapes at mc_batch 96 (EVA ViT-g/14 at 448 px)
MC_BATCH = 96
VIT_TOKENS = 1024
VIT_WIDTH = 1408
VIT_HEADS = 16
VIT_MLP = 6144
VIT_DEPTH = 39

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
# one chunk for selection and one for estimation: warm-up and profile
TWO_CHUNK_RUN_CFG = dict(RUN_CFG, certify_n0=MC_BATCH, certify_n=MC_BATCH,
                         early_abstain=False, early_stop_radius=None)
QUESTION = "<Img><ImageHere></Img> [vqa] Based on the image, what animal is this?"
GT_ANSWERS = ["cat", "cat", "cat", "dog", "cat", "cat", "kitten", "cat", "cat", "cat"]

# kernel-name substrings of each profile group, first match wins
PROFILE_GROUPS = (
    ("cls-split kernel", ("cls_split_kernel",)),
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


def bound_ms(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
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
        if line.startswith("==") or "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def check_row_quant(torch, name, kernel, plain, shapes, ops_per_elem, make_args):
    """Compare an int8 row-quant kernel with its plain version at each
    shape; time the first (the patch stream's) shape."""
    record = None
    for m, k in shapes:
        args = make_args(m, k)
        xq_k, xs_k = kernel(*args)
        xq_p, xs_p = plain(*args)
        torch.cuda.synchronize()
        dq = (xq_k.int() - xq_p.int()).abs()
        off = int((dq > 0).sum())
        worst = int(dq.max())
        frac = off / dq.numel()
        rel = float(((xs_k - xs_p).abs() / xs_p.abs()).max())
        err = float((xq_k.float() * xs_k - xq_p.float() * xs_p).abs().max())
        log(
            f"[kernel] {name} [{m}, {k}]: int8 off-by-one {off}/{dq.numel()} "
            f"({frac:.2e}), max code diff {worst}, scale rel err {rel:.2e}, "
            f"max |dequant diff| {err:.3e}"
        )
        if worst > 1 or frac > 1e-3 or rel > 1e-2:
            fail(f"{name} disagrees with its plain version at [{m}, {k}]")
        if record is None:
            ms = cuda_ms(torch, lambda: kernel(*args), iters=20)
            plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5, warmup=1)
            x = args[0]
            moved = x.numel() * x.element_size() + m * k + 4 * m
            moved += sum(a.numel() * 4 for a in args[1:3] if hasattr(a, "numel"))
            bms, by = bound_ms(moved, ops_per_elem * m * k, PEAK_F32_FLOPS)
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": by, "library_ms": None}
        del args, xq_k, xs_k, xq_p, xs_p
        torch.cuda.empty_cache()
    return record


def check_cls_split(torch, device):
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    b, h, n, d = MC_BATCH, VIT_HEADS, VIT_TOKENS, VIT_WIDTH // VIT_HEADS
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
    torch.cuda.synchronize()
    err = max(
        float((out_p.float() - ref_p.float()).abs().max()),
        float((out_c.float() - ref_c.float()).abs().max()),
    )
    # both against f32 attention on the same (bf16) inputs, for scale
    ex_c, ex_p = FA._cls_split_attention_plain(*(a.float() for a in args))
    err_k = float((out_p.float() - ex_p).abs().max())
    err_p = float((ref_p.float() - ex_p).abs().max())
    log(
        f"[kernel] cls_split_attention [{b}, {h}, {n}, {d}]: max abs err {err:.3e} "
        f"(max |out| {float(ex_p.abs().max()):.3f}; vs f32 attention: kernel "
        f"{err_k:.3e}, plain {err_p:.3e})"
    )
    del ex_c, ex_p
    if not math.isfinite(err) or err > 2e-2:
        fail("cls_split_attention disagrees with its plain version")
    # ms: the kernel alone (the N patch rows); the wrapper adds the plain
    # torch cls query row. plain_ms and library_ms compute all N + 1 rows.
    ms = cuda_ms(torch, lambda: FA._launch_patch_rows(qp, kp, vp, kc, vc), iters=10)
    wrapper_ms = cuda_ms(torch, lambda: FA.cls_split_attention_parts(*args), iters=10)
    plain_ms = cuda_ms(torch, lambda: FA._cls_split_attention_plain(*args), iters=3, warmup=1)
    q = torch.cat([qc, qp], dim=2)
    k = torch.cat([kc, kp], dim=2)
    v = torch.cat([vc, vp], dim=2)
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)),
        iters=10,
    )
    ops = 4.0 * b * h * n * (n + 1) * d  # N query rows over N + 1 keys
    moved = 2.0 * (3 * b * h * n * d + 2 * b * h * d + b * h * n * d)  # q, k, v, kc, vc, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    log(f"[kernel] cls_split_attention: kernel {ms:.3f} ms, wrapper with the plain cls "
        f"row {wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del args, out_c, out_p, ref_c, ref_p, q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "wrapper_ms": wrapper_ms}


def phase_kernels(torch, device):
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(0)
    rows = MC_BATCH * VIT_TOKENS

    def ln_args(m, k):
        x = (torch.randn((m, k), generator=g, device=device) * 3.0).to(torch.bfloat16)
        scale = (1.0 + 0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        return x, scale, bias, 1e-6

    def gelu_args(m, k):
        return ((torch.randn((m, k), generator=g, device=device) * 3.0).to(torch.bfloat16),)

    records = {}
    records["cls_split_attention"] = check_cls_split(torch, device)
    records["ln_quant_rows"] = check_row_quant(
        torch, "ln_quant_rows", Q.ln_quant_rows, Q._ln_quant_rows_plain,
        [(rows, VIT_WIDTH), (MC_BATCH, VIT_WIDTH)], LN_QUANT_OPS_PER_ELEM, ln_args,
    )
    records["gelu_quant_rows"] = check_row_quant(
        torch, "gelu_quant_rows", Q.gelu_quant_rows, Q._gelu_quant_rows_plain,
        [(rows, VIT_MLP), (MC_BATCH, VIT_MLP)], GELU_QUANT_OPS_PER_ELEM, gelu_args,
    )
    return records


KERNELS = [
    # name, source, TPU kernel replaced, launches per chunk
    ("cls_split_attention", "certifiedgpt_tpu_torch/csrc/cls_split_attention.cu",
     "certifiedgpt_tpu/ops/flash_attention.py:258", VIT_DEPTH),
    ("ln_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:208", 4 * VIT_DEPTH),
    ("gelu_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:136", 2 * VIT_DEPTH),
]


def wrappers():
    """Each kernel's wrapper, which carries its launch counter."""
    from certifiedgpt_tpu_torch.ops.flash_attention import cls_split_attention_parts
    from certifiedgpt_tpu_torch.ops.quantization import gelu_quant_rows, ln_quant_rows

    return {"cls_split_attention": cls_split_attention_parts,
            "ln_quant_rows": ln_quant_rows, "gelu_quant_rows": gelu_quant_rows}


# ----------------------------------------------------------------------
# phase 4: the main path
# ----------------------------------------------------------------------
def phase_main_path(torch, device):
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models.eva_vit import EvaViTConfig
    from certifiedgpt_tpu_torch.models.llama import LlamaConfig
    from certifiedgpt_tpu_torch.models.minigpt4 import MiniGPT4Config
    from certifiedgpt_tpu_torch.models.model_zoo import build_synthetic_model

    cfg = MiniGPT4Config(
        vit=EvaViTConfig(attn_impl="flash_cls", act_quant=True),
        llama=LlamaConfig(act_quant=True, kv_quant=True),
    )
    t0 = time.perf_counter()
    model = build_synthetic_model(cfg, device, seed=0)
    torch.cuda.synchronize()
    log(
        f"[main] built full-width model (ViT depth {cfg.vit.depth}, Q-Former "
        f"{cfg.qformer.num_layers} layers, decoder {cfg.llama.num_layers}x"
        f"{cfg.llama.hidden_size}) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card"
    )
    image = np.random.RandomState(0).randn(448, 448, 3).astype(np.float32)

    # warm-up chunk: allocator and cuBLAS heuristics, outside the counted run
    clock = StageClock(device)
    certify_item(model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)

    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = certify_item(model, image, QUESTION, GT_ANSWERS, RUN_CFG, index=0, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    chunks = clock.counts.get("noise", 0)
    stages = {k: round(v, 4) for k, v in clock.seconds.items()}
    stages["other_host"] = round(wall - sum(clock.seconds.values()), 4)
    log(f"[main] certify row: {json.dumps(row)}")
    log(f"[main] wall {wall:.3f} s over {chunks} chunks of {MC_BATCH}; stage seconds {json.dumps(stages)}")
    log(f"[main] decode steps {clock.counts.get('decode_step', 0)}; peak memory {peak_gb:.2f} GB")
    log(f"[main] launches {json.dumps(launches)}")
    for name, _, _, per_chunk in KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if launches[name] != per_chunk * chunks:
            fail(f"kernel {name}: {launches[name]} launches, expected {per_chunk} x {chunks} chunks")

    required = {"index", "question_id", "label", "answer", "radius", "correct",
                "abstain", "seconds", "sigma", "n0", "n", "draws"}
    if set(row) != required:
        fail(f"certify row keys {sorted(row)} != {sorted(required)}")
    if not (isinstance(row["label"], int) and math.isfinite(row["radius"]) and row["radius"] >= 0):
        fail(f"malformed certify row {row}")
    if row["abstain"] != (row["label"] == -1) or not 0 < row["draws"] <= 100 + 1000:
        fail(f"inconsistent certify row {row}")
    decode_costs(torch, model, device)
    check_outputs(torch, model, device)
    phase_profile(torch, model, image)
    return launches, {"wall_seconds": wall, "stage_seconds": stages,
                      "chunks": chunks, "peak_gb": peak_gb, "row": row}


def decode_costs(torch, model, device):
    """What the plain decode path costs per step: the time to convert every
    int8 decoder kernel to bf16 (the weight-only matmuls do this each step)
    against one whole decode step at the certify batch."""
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


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    try:
        import certifiedgpt_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"certifiedgpt_tpu_torch is not importable ({exc}); run from the repository root")

    phase_device(torch)
    device = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        records = phase_kernels(torch, device)
        launches, summary = phase_main_path(torch, device)
    log(f"[main] summary {json.dumps(summary)}")
    kernels = []
    for name, source, replaces, _ in KERNELS:
        rec = records[name]
        lib_ms = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.3f} ms"
        log(f"[kernel] {name}: {rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.3f} ms, library {lib_ms}; "
            f"{launches[name]} launches on the main path, "
            f"{launches[name] / summary['chunks']:.0f} per chunk")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name], **rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
