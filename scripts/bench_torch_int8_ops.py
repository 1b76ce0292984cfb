#!/usr/bin/env python3
"""Where the time of the weight-only int8 product, of the prefill's, of
the decode step's and of the tiled int8-KV kernels goes, on one NVIDIA GPU.

Times a decode layer's seven weight-only products (q/k/v/o at 4096 x 4096,
gate/up at 4096 x 11008, down at 11008 x 4096; ``int8_weight_forward``) at
96, 8 and 1 rows; the prefill's launch with its cache write
(``prefill_attention_kv8``, ``csrc/attention_kv8_prefill.cu``) at the
certify prefill (q [96, 96, 32, 128], 96 new rows into a 106-slot int8
cache), eval's (q [8, 320, 32, 128] over 330 slots) and a caption's (batch
1), with the decoder's causal, left-padded mask; and the decode step's
launch (``decode_attention_kv8``, ``csrc/attention_kv8_decode.cu``) at the
certify decode, a caption's, eval's and a 2048-position cache; each
replayed from a CUDA graph (the card's time alone), first as built and then
with one part compiled out or a design alternative. The weight kernel:
its tensor-core products, the int8 -> bf16 conversion, its x fragments,
its whole compute loop (the copies stay), its cluster reduction, the split
of K, a deeper ring, eight warps a block; its f32 instance (weight32: the
layer on f32 x): the three-term split, the products, the hi term alone,
each step's products summed into the accumulator. The prefill kernel: its mask
reads, its products and softmax (the copies, conversions and cache write
stay), its quantization, its mask scan, its K tiles kept for pass 2 and
the row scales reused, 16 warps a block, the units in grid order, the
proxy fences; its blocks' timelines (the mask's bits, pass
1, pass 2; or staging and scan), and thread 0's summed waits on the copies
and at the barrier. The decode kernel: its conversion cut to a bit
operation, its compute loops skipped (the copies alone), a block a batch
row, a three-stage ring, a register cap for four blocks an SM, every launch
at 4 or at 8 warps a block, and its blocks' timelines (first tile in place,
first item done, the rest). The tiled kernel (the f32 prefill at the
certify prefill, eval's and a 2048-slot cache): its new rows' quantization,
its mask reads, its products, its first pass. A variant computes wrong
values; only its time means anything.

Each variant is a copy of the source with its edits applied, built by
``nvcc`` into a library of its own; all builds run in parallel, then every
variant is timed through the package's wrappers in one process, in turns, so
that their times compare on one card:

    python3 scripts/bench_torch_int8_ops.py            # all variants
    python3 scripts/bench_torch_int8_ops.py weight:whole prefill:whole prefill:timeline
    python3 scripts/bench_torch_int8_ops.py decode:whole decode:copies_only decode:timeline

Prints one line per variant with the card's name and power limit, the
times, the weights' rate and share of the byte bound (3.35 TB/s), and
ptxas' registers of the variant's kernels.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PEAK_BYTES_PER_S = 3.35e12
# cgpt_int8_weight_matmul_plan's fields
PLAN_FIELDS = ("rows a block", "row tiles", "channel tiles", "splits", "K a split",
               "resident blocks", "stages")
# (K, N, products a decoder layer) of Vicuna-7B
LAYER = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
ROWS = (96, 8, 1)
# the certify prefill, eval's and a caption's: (batch, query rows, heads, kv
# heads, cached positions, head_dim, the first new row's slot)
PREFILLS = {"certify prefill": (96, 96, 32, 32, 106, 128, 0),
            "eval prefill": (8, 320, 32, 32, 330, 128, 0),
            "caption prefill": (1, 96, 32, 32, 106, 128, 0)}
# the f32 prefill (the tiled kernel) at the certify prefill, eval's and a
# 2048-slot cache: (batch, new rows, cached positions, the first new row's slot)
TILED = {"certify prefill": (96, 96, 106, 0), "eval prefill": (8, 320, 330, 0),
         "2048 slots": (8, 96, 2048, 1900)}
# the certify decode, a caption's, eval's and a long cache: (batch, heads,
# kv heads, cached positions, head_dim, the step's slot)
DECODES = {"certify decode": (96, 32, 32, 106, 128, 100),
           "caption decode": (1, 32, 32, 106, 128, 100),
           "eval decode": (8, 32, 32, 330, 128, 321),
           "long cache": (96, 32, 32, 2048, 128, 2000)}

# edits that apply to both sources (the same helpers in each)
_NO_MMA = [(r'asm volatile\(\n\s*"mma\.sync.*?"r"\(b1\)\);',
            "c[0] = __fadd_rn(c[0], __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) "
            "& 0x3f800000u));")]
_NO_CONVERT = [(r"(void bf16x4_of\(uint32_t w, uint32_t& lo, uint32_t& hi\) \{)",
                r"\1\n  lo = w;\n  hi = w ^ 0x00800080u;\n  return;")]
_DEEP_RING = [(r"kRingBytes = 110 \* 1024;", "kRingBytes = 220 * 1024;"),
              (r"__launch_bounds__\(kThreads, 2\)", "__launch_bounds__(kThreads, 1)")]
WEIGHT_VARIANTS = {
    "whole": [],
    "no_mma": _NO_MMA,
    "no_convert": _NO_CONVERT,
    "no_x_frags": [(r"x_frags<X>\(xt \+ [^;]*;",
                    "for (int e = 0; e < kTerms; ++e) { xb[e][0] = af[0][(j + e) & 3]; "
                    "xb[e][1] = af[1][(j + e + 1) & 3]; }")],
    "copies_only": [(r"(    cp_async_commit\(\);\n)(    const unsigned char\* wt = )",
                     r"\1    if (a.M > 0) continue;\n\2")],
    "no_reduction": [(r"(  cp_async_wait<0>\(\);\n  __syncthreads\(\);[^\n]*\n)",
                      r"\1  if (acc[0][0][0] != 1.2345f) return;\n")],
    "splits_1": [(r"kMaxSplits = 3;", "kMaxSplits = 1;")],
    "splits_2": [(r"kMaxSplits = 3;", "kMaxSplits = 2;")],
    "splits_8": [(r"kMaxSplits = 3;", "kMaxSplits = 8;")],
    "deep_ring": _DEEP_RING,
    "warps_8": _DEEP_RING + [(r"kWarps = 4;", "kWarps = 8;")],
    # the weight copies ask the L2 for the 256 bytes around them, or only
    # for their own 16
    "l2_256": [(r"\.L2::128B \[", ".L2::256B [")],
    "no_line_fetch": [(r"cp_async16_line\(stage \+ w_dst", "cp_async16(stage + w_dst")],
    # the reduction reads its own block's partials only: no distributed
    # shared memory traffic
    "local_reduction": [(r'asm volatile\("mapa\.shared::cluster\.u32 %0, %1, %2;" : "=r"\(remote\) : '
                         r'"r"\(local\), "r"\(rank\)\);', "remote = local + 0 * rank;"),
                        (r"ld\.shared::cluster\.v4\.f32", "ld.shared.v4.f32")],
    # each block walks its K tiles from a point of its own (blockIdx.x)
    "rotate": [(r"(  const int tiles = [^\n]*\n)", r"\1  const int rot = blockIdx.x % tiles;\n"),
               (r"k_begin \+ s \* kBK", "k_begin + ((s + rot) % tiles) * kBK"),
               (r"k_begin \+ next \* kBK", "k_begin + ((next + rot) % tiles) * kBK")],
    # x read by the first column of blocks only: the L2 traffic of x gone
    "x_once": [(r"(x\[i\] = r < Tile<MT, X>::kRows && m0 \+ r < a\.M)", r"\1 && blockIdx.x == 0")],
}
# the prefill's launch (csrc/attention_kv8_prefill.cu): as built; its mask
# reads gone (every position of a row kept); its products and softmax
# skipped (the copies, the conversions and the cache write stay); up to 16
# warps a block (one block an SM)
PREFILL_VARIANTS = {
    "whole": [],
    "no_mask_reads": [(r"uint32_t v = __funnelshift_r\(w\[0\], w\[1\], 8 \* \(at & 3\)\);",
                       "uint32_t v = 0x01010101u;"),
                      (r"mb\[k\]\[j\] = __ldg\([^;]*;", "mb[k][j] = 1;")],
    "copies_only": [(r"    if \(!has_rows\) continue;", "    if (!has_rows || a.scale != 12345.f) continue;")],
    "warps_16": [(r"kMaxWarps = 8;", "kMaxWarps = 16;"), (r"kMinBlocks = 2;", "kMinBlocks = 1;")],
    # the units in grid order (an item's longest last)
    "unit_order": [(r"unit = gridDim\.z - 1 - blockIdx\.z;", "unit = blockIdx.z;")],
    # no proxy fence before a stage is refilled (the barrier alone orders the
    # reads before the next copy)
    "no_proxy_fence": [(r"(\n  )?  fence_proxy_async\(\);[^\n]*\n", "\n")],
    # pass 2 quantizes K's rows anew, scales and all
    "no_scale_reuse": [(r"two && !walk\.cached && sp\.tile < walk\.n1, st,", "false, st,")],
    # pass 1's K tiles never kept for pass 2
    "no_cache": [(r"p->cache = full <= two \|\| \(bare > two && full <= most\) \? keys : 0;",
                  "p->cache = 0;")],
    # the new rows' codes made copies of their values (no quantization)
    "no_quantize": [(r"cgpt_kv8::codes_of\(x, xs, rcp, qf, bytes\);",
                     "for (int j = 0; j < 8; ++j) qf[j] = x[j]; "
                     "for (int j = 0; j < 2; ++j) bytes[j] = ws[j];")],
    # no scan of the mask: every position of the unit's rows kept
    "no_scan": [(r"  \{\n    const int hi =\n        staged \?.*?    if \(lane == 0\) atomicMax\(range, warp_hi\);\n  \}\n",
                 "  for (int i = threadIdx.x; i < 16 * warps * L.stride; i += blockDim.x) "
                 "bits[i] = 0xffffffffu;\n  if (threadIdx.x == 0) range[0] = a.T - 1;\n")],
}
# the timeline variants: thread 0 of each block writes %globaltimer at its
# phases' ends into g_stamps (4 a block), read back by cgpt_debug_stamps
_STAMPS = (r"(#include <stdint\.h>\n)", r"""\1
__device__ unsigned long long g_stamps[4 * 65536];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int cgpt_debug_stamps(void* host, long long bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, bytes));
}
extern "C" int cgpt_debug_clear_stamps() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, g_stamps);
  return static_cast<int>(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(g_stamps)));
}
""")
WEIGHT_VARIANTS["timeline"] = [
    _STAMPS,
    (r"(  const uint32_t base = smem_u32\(smem\);\n)",
     r"\1  const unsigned long long t_start = stamp_now();\n"),
    (r"(  cp_async_wait<0>\(\);\n  __syncthreads\(\);  // every warp is done with the ring)",
     r"  const unsigned long long t_loop = stamp_now();\n\1"),
    (r"(  cluster_sync\(\);  // every split's partial tile is in place\n)",
     r"\1  const unsigned long long t_sync = stamp_now();\n"),
    (r"(  if \(splits > 1\) cluster_sync\(\);[^\n]*\n)\}",
     r"\1  if (threadIdx.x == 0) { unsigned long long* st = g_stamps + 4 * (blockIdx.x + "
     r"gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)); st[0] = t_start; st[1] = t_loop; "
     r"st[2] = t_sync; st[3] = stamp_now(); }\n}"),
]
# the prologue's phase ends: q's rows and the mask's bytes landed (the
# staging __syncthreads), the mask's bits made, the rest
PREFILL_VARIANTS["timeline_prologue"] = [
    _STAMPS,
    (r"(  extern __shared__ __align__\(128\) unsigned char smem\[\];\n)",
     r"\1  const unsigned long long t_start = stamp_now();\n"),
    (r"(  __syncthreads\(\);  // the staged mask bytes are in place\n)",
     r"\1  const unsigned long long t_sync = stamp_now();\n"),
    (r"(  __syncthreads\(\);  // the bits and the last kept position are in place\n)",
     r"\1  const unsigned long long t_scan = stamp_now();\n"),
    (r"(  // the output rows gr and gr \+ 8 of the warp's tile)",
     r"  if (threadIdx.x == 0) { unsigned long long* st = g_stamps + 4 * (blockIdx.x + "
     r"gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)); st[0] = t_start; st[1] = t_sync; "
     r"st[2] = t_scan; st[3] = stamp_now(); }\n\1"),
]
# thread 0's waits in the tile loop, summed: on the tensor copies (the
# mbarrier) and at the loop's __syncthreads; and the loop's steps
PREFILL_VARIANTS["timeline_waits"] = [
    _STAMPS,
    (r"(  extern __shared__ __align__\(128\) unsigned char smem\[\];\n)",
     r"\1  const unsigned long long t_start = stamp_now();\n"
     r"  unsigned long long w_copy = 0, w_sync = 0, n_steps = 0;\n"),
    (r"(    mbarrier_wait\(bars \+ 8 \* stage, \(phases >> stage\) & 1\);\n)",
     r"    const unsigned long long w0 = stamp_now();\n\1    w_copy += stamp_now() - w0;\n"
     r"    ++n_steps;\n"),
    (r"(    __syncthreads\(\);  // the codes are in place, the stage is read\n)",
     r"    const unsigned long long w1 = stamp_now();\n\1    w_sync += stamp_now() - w1;\n"),
    (r"(  asm volatile\(\"cp\.async\.wait_all;\\n\" ::: \"memory\"\);)",
     r"  if (threadIdx.x == 0) { unsigned long long* st = g_stamps + 4 * (blockIdx.x + "
     r"gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)); st[0] = stamp_now() - t_start; "
     r"st[1] = w_copy; st[2] = w_sync; st[3] = n_steps; }\n\1"),
]
PREFILL_VARIANTS["timeline"] = [
    _STAMPS,
    (r"(  extern __shared__ __align__\(128\) unsigned char smem\[\];\n)",
     r"\1  const unsigned long long t_start = stamp_now();\n"),
    (r"(  __syncthreads\(\);  // the bits and the last kept position are in place\n)",
     r"\1  const unsigned long long t_scan = stamp_now();\n  unsigned long long t_pass1 = t_scan;\n"),
    (r"(    if \(e == walk\.n1\) \{\n)", r"\1      t_pass1 = stamp_now();\n"),
    (r"(  // the output rows gr and gr \+ 8 of the warp's tile)",
     r"  if (threadIdx.x == 0) { unsigned long long* st = g_stamps + 4 * (blockIdx.x + "
     r"gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)); st[0] = t_start; st[1] = t_scan; "
     r"st[2] = t_pass1; st[3] = stamp_now(); }\n\1"),
]
# the decode step's launch (csrc/attention_kv8_decode.cu): as built; its
# conversion made one bit operation a value; its compute loops skipped (the
# copies, the cache write, the softmax and the reductions stay); its blocks'
# phase ends (the first item's K tile in place, the first item done, the
# block's last item done)
DECODE_VARIANTS = {
    "whole": [],
    "no_convert": [(r"(void bytes_f32\(uint4 w, float \(&f\)\[16\]\) \{)",
                    r"\1\n  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};\n"
                    r"#pragma unroll\n  for (int i = 0; i < 16; ++i) "
                    r"f[i] = __uint_as_float(ws[i / 4] << (8 * (i % 4)));\n  return;")],
    "copies_only": [(r"r0 < rows;", "r0 < rows * (a.scale == 12345.f);")],
    # a block a batch row (no walk over rows); a three-stage ring; registers
    # for four blocks of 8 warps an SM
    "one_item": [(r"rows_blocks = rows_blocks < 1 \? 1 : \(rows_blocks > B \? B : rows_blocks\);",
                  "rows_blocks = B;")],
    "stages_3": [(r"kStages = 2;", "kStages = 3;")],
    "min_blocks_4": [(r"kMinBlocks = 3;", "kMinBlocks = 4;")],
    # every launch at 4 or at 8 warps a block (the launcher picks 4 for the
    # certify decode, 8 for the others)
    "warps_4": [(r"\? 4 : kMaxWarps;", "? 4 : 4;")],
    "warps_8": [(r"\? 4 : kMaxWarps;", "? kMaxWarps : kMaxWarps;")],
    "timeline": [
        _STAMPS,
        (r"(  extern __shared__ __align__\(128\) unsigned char smem\[\];\n)",
         r"\1  const unsigned long long t_start = stamp_now();\n"
         r"  unsigned long long t_k = 0, t_item = 0;\n"),
        (r"(      __syncthreads\(\);  // the tile, the scales, the mask and the quantized rows are "
         r"in place\n)", r"\1      if (c == 0 && k == 0) t_k = stamp_now();\n"),
        (r"(      store\(orow \+ i, s\);\n    \}\n)  \}\n\}",
         r"\1    if (k == 0) t_item = stamp_now();\n  }\n"
         r"  if (threadIdx.x == 0) { unsigned long long* st = g_stamps + 4 * (blockIdx.x + "
         r"gridDim.x * blockIdx.y); st[0] = t_start; st[1] = t_k; st[2] = t_item; "
         r"st[3] = stamp_now(); }\n}"),
    ],
}
# the weight-only kernel's f32 instance (the same file, f32 x): as built; x's
# three-term split replaced by plain bit copies; its products skipped; the
# hi term's product alone; each step's products summed into the accumulator
# (no separate sum and IEEE add)
WEIGHT_F32_VARIANTS = {
    "whole": [],
    "no_split": [(r"      t\[2\]\[i\] = __float_as_uint\(x\[i\]\) & 0xFFFF0000u;\n.*?"
                  r"t\[0\]\[i\] = __float_as_uint\(__fsub_rn\(r, __uint_as_float\(t\[1\]\[i\]\)\)\);",
                  "      t[2][i] = __float_as_uint(x[i]); t[1][i] = t[2][i] ^ 1u; "
                  "t[0][i] = t[2][i] ^ 2u;")],
    "no_mma": _NO_MMA,
    "hi_only": [(r"for \(int e = 0; e < kTerms; \+\+e\) mma_bf16\(part",
                 "for (int e = kTerms - 1; e < kTerms; ++e) mma_bf16(part")],
    "direct_acc": [(r"float part\[4\] = \{0\.f, 0\.f, 0\.f, 0\.f\};",
                    "float (&part)[4] = acc[i][j];"),
                   (r"for \(int c = 0; c < 4; \+\+c\) acc\[i\]\[j\]\[c\] = "
                    r"__fadd_rn\(acc\[i\]\[j\]\[c\], part\[c\]\);", "")],
    "copies_only": WEIGHT_VARIANTS["copies_only"],
}
# the tiled kernel (csrc/attention_kv8.cu) at the f32 prefill: as built; its
# new rows' quantization into the cache skipped; its mask reads gone; its
# products skipped; its first pass skipped; launched without clusters
TILED_VARIANTS = {
    "whole": [],
    "no_quantize": [(r"    write_new_rows\(a, it, cluster_rank\(\), cluster_blocks\(\)\);",
                     "")],
    "no_mask": [(r"byte\[c\] = m == nullptr \? 1 : __ldg\([^;]*;", "byte[c] = 1;")],
    "no_mma": _NO_MMA,
    "one_pass": [(r"  pass\(false, \[&\]", "  if (a.Sq < 0) pass(false, [&]")],
    # no cluster: each block quantizes every new row itself
    "no_cluster": [(r"const int cluster = a\.kn == nullptr \? 1 : [^;]*;", "const int cluster = 1;")],
}
SOURCES = {"weight": ("int8_weight_matmul.cu", WEIGHT_VARIANTS, "cgpt_int8_weight_matmul"),
           "weight32": ("int8_weight_matmul.cu", WEIGHT_F32_VARIANTS, "cgpt_int8_weight_matmul"),
           "prefill": ("attention_kv8_prefill.cu", PREFILL_VARIANTS, "cgpt_attention_kv8_prefill"),
           "decode": ("attention_kv8_decode.cu", DECODE_VARIANTS, "cgpt_attention_kv8_decode"),
           "tiled": ("attention_kv8.cu", TILED_VARIANTS, "cgpt_attention_kv8")}
_ERROR_STRING = """#include <cuda_runtime.h>
extern "C" const char* cgpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def graph_ms(torch, fn, reps: int = 10) -> float:
    """Milliseconds of ``fn`` replayed from a CUDA graph of ``reps`` calls
    (the best of five replays, over ``reps``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


class _Build:
    """What the wrappers read from ``cuda_kernels.build()``: the library."""

    def __init__(self, lib):
        self.lib = lib


def build_variants(names, tmp: Path):
    """Edit and compile each (source, variant) once, all in parallel;
    returns {(source, variant): (library, ptxas register lines)}."""
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    errors = tmp / "error_string.cu"
    errors.write_text(_ERROR_STRING)
    procs = {}
    for src, name in names:
        file, variants, _entry = SOURCES[src]
        text = (cuda_kernels.CSRC / file).read_text()
        for pattern, repl in [e for part in name.split("+") for e in variants[part]]:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if n == 0:
                raise SystemExit(f"{src}:{name}: the edit {pattern!r} matched nothing")
        unit = tmp / f"{src}_{name}.cu"
        unit.write_text(text)
        lib = tmp / f"lib{src}_{name}.so"
        procs[(src, name)] = (lib, subprocess.Popen(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-I", str(cuda_kernels.CSRC),
             "-shared", str(unit), str(errors), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {key}:\n{out}")
        lib = ctypes.CDLL(str(path))
        entry = SOURCES[key[0]][2]
        getattr(lib, entry).argtypes = cuda_kernels._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        lib.cgpt_error_string.argtypes = (ctypes.c_int,)
        lib.cgpt_error_string.restype = ctypes.c_char_p
        regs = [re.sub(r".*Used ", "", line) for line in out.splitlines() if "Used" in line]
        built[key] = (lib, regs)
    return built


def weight_cases(torch, dev, dtype=None):
    """{rows: a call of a decoder layer's seven products} on x of ``dtype``
    (bf16 by default), and the layer's weight bytes."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(0)
    weights = []  # seven weights of their own (202 MB, more than the L2 holds)
    for k, n, per_layer in LAYER:
        for _ in range(per_layer):
            kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g,
                                                    device=dev, dtype=torch.int8))
            weights.append((kq, torch.rand(n, generator=g, device=dev) * 1e-3))
    calls = {}
    for m in ROWS:
        xs = {k: torch.randn((m, k), generator=g, device=dev).to(dtype or torch.bfloat16)
              for k in {k for k, _n, _p in LAYER}}

        def layer(xs=xs):
            for kq, scale in weights:
                Q.int8_weight_forward(xs[kq.shape[0]], kq, scale)

        calls[m] = layer
    return calls, sum(k * n * p for k, n, p in LAYER)


def product_cases(torch, dev):
    """(label, call, (M, K, N)) of single products for the timeline."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(2)
    out = []
    for m, k, n in ((96, 4096, 4096), (96, 4096, 11008), (96, 11008, 4096), (1, 4096, 4096)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                                dtype=torch.int8))
        scale = torch.rand(n, generator=g, device=dev)
        out.append((f"[{m}, {k}] x [{k}, {n}]",
                    lambda x=x, kq=kq, scale=scale: Q.int8_weight_forward(x, kq, scale),
                    (m, k, n)))
    return out


def prefill_case(torch, dev, b, sq, h, h_kv, t, d, offset):
    """A prefill's launch (``prefill_attention_kv8``: its new rows written
    into a quantized cache) with the decoder's mask, row 0 left-padded."""
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, sq, h_kv, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    kq, ks = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=dev)
                             .to(torch.bfloat16))
    vq, vs = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=dev)
                             .to(torch.bfloat16))
    cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    valid[0, :2] = False
    q_pos = offset + torch.arange(sq, device=dev)[:, None]
    mask = (torch.arange(t, device=dev)[None, :] <= q_pos)[None, None] & valid[:, None, None]
    return lambda: A.prefill_attention_kv8(q, k, v, cache, offset, mask)


def prefill_blocks(lib, b, sq, h, h_kv, t, _d, offset) -> int:
    """Blocks the prefill's launcher plans: kv heads x batch x units."""
    plan = (ctypes.c_int * 5)()
    lib.cgpt_attention_kv8_prefill_plan.argtypes = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
    if lib.cgpt_attention_kv8_prefill_plan(b, sq, h, h_kv, t, offset, sq, plan) != 0:
        raise SystemExit("cgpt_attention_kv8_prefill_plan failed")
    return h_kv * b * plan[1]


def tiled_case(torch, dev, b, s, t, offset):
    """An f32 prefill's launch (``prefill_attention_kv8`` on f32: the tiled
    kernel with its cache write), 32 heads of 128, with the causal mask."""
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((b, s, 32, 128), generator=g, device=dev) for _ in range(3))
    kq, ks = Q._quantize_rows_plain(torch.randn((b, t, 32, 128), generator=g, device=dev))
    vq, vs = Q._quantize_rows_plain(torch.randn((b, t, 32, 128), generator=g, device=dev))
    cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    q_pos = offset + torch.arange(s, device=dev)[:, None]
    mask = (torch.arange(t, device=dev)[None, :] <= q_pos)[None, None]
    return lambda: A.prefill_attention_kv8(q, k, v, cache, offset, mask)


def decode_case(torch, dev, b, h, h_kv, t, d, offset):
    """A decode step's launch (``decode_attention_kv8``) over a quantized
    cache with the decoder's mask, row 0 left-padded."""
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((b, 1, n, d), generator=g, device=dev).to(torch.bfloat16)
               for n in (h, h_kv, h_kv))
    kq, ks = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=dev)
                             .to(torch.bfloat16))
    vq, vs = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=dev)
                             .to(torch.bfloat16))
    cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    valid[0, :2] = False
    mask = (torch.arange(t, device=dev) <= offset)[None, None, None, :] & valid[:, None, None]
    return lambda: A.decode_attention_kv8(q, k, v, cache, offset, mask)


def blocks(lib, mkn) -> int:
    """Blocks the launcher plans for an (M, K, N) product."""
    m, k, n = mkn
    plan = (ctypes.c_int * 7)()
    lib.cgpt_int8_weight_matmul_plan.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
    if lib.cgpt_int8_weight_matmul_plan(m, n, k, 0, plan) != 0:
        raise SystemExit("cgpt_int8_weight_matmul_plan failed")
    return plan[1] * plan[2] * plan[3]


def plans(lib):
    """The launcher's plan for each product of a decoder layer at ``ROWS``."""
    lib.cgpt_int8_weight_matmul_plan.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
    out = []
    for m in ROWS:
        for k, n, _p in LAYER:
            plan = (ctypes.c_int * 7)()
            if lib.cgpt_int8_weight_matmul_plan(m, n, k, 0, plan) != 0:
                raise SystemExit("cgpt_int8_weight_matmul_plan failed")
            out.append(f"weight:plan [{m}, {k}] x [{k}, {n}]: " + ", ".join(
                f"{name} {v}" for name, v in zip(PLAN_FIELDS, plan)))
    return out


def timeline(torch, lib, call, blocks: int) -> str:
    """One launch of ``call`` with the timeline variant: its blocks' phase
    ends (%globaltimer, ns) summarized in microseconds."""
    import numpy as np

    call()
    torch.cuda.synchronize()
    if lib.cgpt_debug_clear_stamps() != 0:  # no stamp of another launch is read
        raise SystemExit("cgpt_debug_clear_stamps failed")
    call()
    torch.cuda.synchronize()
    stamps = np.zeros(4 * blocks, dtype=np.uint64)
    lib.cgpt_debug_stamps.argtypes = (ctypes.c_void_p, ctypes.c_longlong)
    if lib.cgpt_debug_stamps(stamps.ctypes.data, stamps.nbytes) != 0:
        raise SystemExit("cgpt_debug_stamps failed")
    st = stamps.reshape(blocks, 4).astype(np.int64)
    st = st[st[:, 0] > 0]
    t0 = st[:, 0].min()
    us = (st - t0) / 1e3
    parts = [f"{blocks} blocks, span {us[:, 3].max():.2f} us, starts {us[:, 0].min():.2f}-"
             f"{us[:, 0].max():.2f} us"]
    for i, name in ((1, "phase 1"), (2, "phase 2"), (3, "phase 3")):
        d = us[:, i] - us[:, i - 1]
        parts.append(f"{name} median {np.median(d):.2f} max {d.max():.2f} us")
    return "; ".join(parts)


def waits(torch, lib, call, blocks: int) -> str:
    """One launch of ``call`` with the timeline_waits variant: the medians
    of a block's span, thread 0's summed waits on the tensor copies and at
    the loop's barrier, and its steps."""
    import numpy as np

    call()
    torch.cuda.synchronize()
    if lib.cgpt_debug_clear_stamps() != 0:
        raise SystemExit("cgpt_debug_clear_stamps failed")
    call()
    torch.cuda.synchronize()
    stamps = np.zeros(4 * blocks, dtype=np.uint64)
    lib.cgpt_debug_stamps.argtypes = (ctypes.c_void_p, ctypes.c_longlong)
    if lib.cgpt_debug_stamps(stamps.ctypes.data, stamps.nbytes) != 0:
        raise SystemExit("cgpt_debug_stamps failed")
    st = stamps.reshape(blocks, 4).astype(np.float64)
    st = st[st[:, 3] > 0]
    med = np.median(st, axis=0)
    return (f"{blocks} blocks: median span {med[0] / 1e3:.2f} us, waits on the copies "
            f"{med[1] / 1e3:.2f} us, at the barrier {med[2] / 1e3:.2f} us, over {med[3]:.0f} steps")


def main() -> int:
    import torch

    from certifiedgpt_tpu_torch.ops import cuda_kernels

    if sys.argv[1:]:
        names = [tuple(a.split(":", 1)) for a in sys.argv[1:]]
    else:
        names = [(src, v) for src, (_f, variants, _e) in SOURCES.items() for v in variants]
    for src, name in names:  # a variant may join several with "+"
        if src not in SOURCES or any(p not in SOURCES[src][1] for p in name.split("+")):
            raise SystemExit(f"unknown variant {src}:{name}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = card()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        built = build_variants(names, Path(tmp))
        layer_calls, layer_bytes = weight_cases(torch, dev)
        layer_calls32, _ = weight_cases(torch, dev, torch.float32)
        prefills = {label: prefill_case(torch, dev, *shape) for label, shape in PREFILLS.items()}
        decodes = {label: decode_case(torch, dev, *shape) for label, shape in DECODES.items()}
        tiled = {label: tiled_case(torch, dev, *shape) for label, shape in TILED.items()}
        times = {}
        for _ in range(2):  # two rounds, variants in turns
            for key in names:
                cuda_kernels.build = lambda lib=built[key][0]: _Build(lib)
                if key[0] in ("weight", "weight32"):
                    for m, call in (layer_calls if key[0] == "weight" else layer_calls32).items():
                        times.setdefault((key, m), []).append(graph_ms(torch, call))
                elif key[0] in ("prefill", "tiled"):
                    for label, call in (prefills if key[0] == "prefill" else tiled).items():
                        times.setdefault((key, label), []).append(graph_ms(torch, call))
                else:
                    for label, call in decodes.items():
                        times.setdefault((key, label), []).append(graph_ms(torch, call))
        lines = []
        for key in names:
            if not any(part.startswith("timeline") for part in key[1].split("+")):
                continue
            cuda_kernels.build = lambda lib=built[key][0]: _Build(lib)
            if key[0] == "weight":
                lines += [f"weight:timeline {label} (phases: main loop, first cluster barrier, "
                          f"reduction): {timeline(torch, built[key][0], call, blocks(lib, mkn))}"
                          for label, call, mkn in product_cases(torch, dev)
                          for lib in (built[key][0],)]
            elif key[0] == "prefill" and "timeline_waits" in key[1]:
                lines += [f"prefill:{key[1]} {label}: "
                          f"{waits(torch, built[key][0], call, prefill_blocks(built[key][0], *shape))}"
                          for label, call in prefills.items() for shape in (PREFILLS[label],)]
            elif key[0] == "prefill":
                phases = ("q and the mask's bytes landed, the mask's bits, the rest"
                          if "timeline_prologue"
                          in key[1] else "the mask's bits, pass 1, pass 2")
                lines += [f"prefill:{key[1]} {label} (phases: {phases}): "
                          f"{timeline(torch, built[key][0], call, prefill_blocks(built[key][0], *shape))}"
                          for label, call in prefills.items() for shape in (PREFILLS[label],)]
            else:
                lines += [f"decode:timeline {label} (phases: the first K tile in place, "
                          f"the first item done, the remaining items): "
                          f"{timeline(torch, built[key][0], decodes[label], shape[0] * shape[2])}"
                          for label, shape in DECODES.items()]
        if ("weight", "whole") in names:
            lines += plans(built[("weight", "whole")][0])
    for line in lines:
        print(line, flush=True)
    bound = layer_bytes / PEAK_BYTES_PER_S * 1e3
    for key in names:
        regs = "; ".join(built[key][1])
        if key[0] in ("weight", "weight32"):
            parts = []
            for m in ROWS:
                ms = min(times[(key, m)])
                parts.append(f"M={m} {ms:.4f} ms ({layer_bytes / ms * 1e-6:.0f} GB/s of "
                             f"weights, {100 * bound / ms:.0f} % of the byte bound)")
            print(f"{key[0]}:{key[1]}: a decode layer's seven products "
                  f"{'(f32 x) ' if key[0] == 'weight32' else ''}{', '.join(parts)} "
                  f"[ptxas: {regs}] ({smi})", flush=True)
        elif key[0] in ("prefill", "tiled"):
            parts = [f"{label} {min(times[(key, label)]):.4f} ms"
                     for label in (PREFILLS if key[0] == "prefill" else TILED)]
            print(f"{key[0]}:{key[1]}: {', '.join(parts)} [ptxas: {regs}] ({smi})", flush=True)
        else:
            parts = [f"{label} {min(times[(key, label)]):.4f} ms" for label in DECODES]
            print(f"decode:{key[1]}: {', '.join(parts)} [ptxas: {regs}] ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
