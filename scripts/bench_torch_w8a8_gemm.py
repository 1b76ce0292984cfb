#!/usr/bin/env python3
"""Where the time of the W8A8 GEMM (``csrc/w8a8_gemm.cu``, behind
``ops/quantization.py::w8a8_product``) goes, on one NVIDIA GPU.

Times the products of a certify chunk (the ViT's four on the patch stream,
M = 98304; the prefill's three, M = 9216; the cls stream's four, M = 96)
at bf16 with the path's bias, each replayed from a CUDA graph (the card's
time alone), first as built and then with one part changed or compiled
out:

- ``no_cluster``: clusters of one block (each block loads its whole B tile);
- ``no_epilogue``: the rescale and the store skipped (the products stay);
- ``no_rescale``: the rescale skipped (the staging and the store stay);
- ``loads_only``: the products skipped (the ring's copies and barriers and
  the epilogue stay);
- ``tail_read``: a block's last TMA stores waited for only until they have
  read shared memory, not until their writes are done.

A variant that skips work computes wrong values; only its time means
anything. Each variant is a copy of the source with its edits applied,
built by ``nvcc`` into a library of its own, all builds in parallel; then
every variant is timed through the package's wrapper in one process, in
turns (as built first and last), so that their times compare on one card:

    python3 scripts/bench_torch_w8a8_gemm.py              # every variant
    python3 scripts/bench_torch_w8a8_gemm.py whole no_cluster

Prints one line per variant and shape with the card's name and power
limit, the time, its share of the bound (int8 operations at 1979 TOP/s,
or the bytes at 3.35 TB/s for the cls stream's), the L2 reads the plan
implies over that time, and ptxas' registers and spills of the variant's
instances. Run from a tree without the variants' constants (an older
kernel), only ``whole`` builds.
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

PEAK_INT8_OPS = 1979e12
# csrc/w8a8_gemm.cu's tile rows and K step (bytes)
BLOCK_M, BLOCK_K = 128, 128
PEAK_BYTES_PER_S = 3.35e12
# (label, M, K, N, the path's bias) of a certify chunk's products
SHAPES = (("ViT qkv", 98304, 1408, 4224, True), ("ViT proj", 98304, 1408, 1408, True),
          ("ViT fc1", 98304, 1408, 6144, True), ("ViT fc2", 98304, 6144, 1408, True),
          ("prefill q/k/v/o", 9216, 4096, 4096, False),
          ("prefill gate/up", 9216, 4096, 11008, False),
          ("prefill down", 9216, 11008, 4096, False),
          ("cls qkv", 96, 1408, 4224, True), ("cls proj", 96, 1408, 1408, True),
          ("cls fc1", 96, 1408, 6144, True), ("cls fc2", 96, 6144, 1408, True))
VARIANTS = {
    "whole": [],
    "no_cluster": [(r"constexpr int kClusterWide = 2;", "constexpr int kClusterWide = 1;")],
    "no_epilogue": [(r"    epilogue<BN, kOut>\(p, ", "    if (p.M < 0) epilogue<BN, kOut>(p, ")],
    "no_rescale": [(r"      rescale_group<BN, kOut>\(acc, ", "      if (p.M < 0) rescale_group<BN, kOut>(acc, ")],
    "loads_only": [(r"        wgmma_tile<BN>\(acc, ", "        if (p.M < 0) wgmma_tile<BN>(acc, ")],
    "tail_read": [(r"if \(threadIdx.x % 32 == 0\) bulk_wait\(\);",
                   "if (threadIdx.x % 32 == 0) bulk_wait_read();")],
}
# the fields of cgpt_w8a8_gemm_plan's answer (chip_smoke.py's W8A8_GEMM_PLAN)
PLAN = ("tile_n", "stages", "row_tiles", "channel_tiles", "tiles", "blocks", "smem_bytes",
        "cluster", "k_splits", "k_steps_a_split", "epilogue")
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
    """What the wrapper reads from ``cuda_kernels.build()``: the library."""

    def __init__(self, lib):
        self.lib = lib


def build_variants(names, tmp: Path):
    """Edit and compile each variant once, all in parallel; returns
    {variant: (library, ptxas' register and spill lines)}."""
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    errors = tmp / "error_string.cu"
    errors.write_text(_ERROR_STRING)
    source = (cuda_kernels.CSRC / "w8a8_gemm.cu").read_text()
    procs = {}
    for name in names:
        text = source
        for pattern, repl in VARIANTS[name]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise SystemExit(f"{name}: the edit {pattern!r} matched nothing")
        unit = tmp / f"w8a8_{name}.cu"
        unit.write_text(text)
        lib = tmp / f"libw8a8_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-I", str(cuda_kernels.CSRC),
             "-shared", str(unit), str(errors), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(path))
        for entry in ("cgpt_w8a8_gemm", "cgpt_w8a8_gemm_plan"):
            getattr(lib, entry).argtypes = cuda_kernels._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        lib.cgpt_error_string.argtypes = (ctypes.c_int,)
        lib.cgpt_error_string.restype = ctypes.c_char_p
        regs = sorted({re.sub(r".*Used ", "", line).strip() for line in out.splitlines()
                       if "Used" in line or "spill" in line})
        built[name] = (lib, regs)
    return built


def cases(torch, dev):
    """(label, call, bound ms, plan arguments) of each shape."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=dev).manual_seed(22)
    out = []
    for label, m, k, n, with_bias in SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                                dtype=torch.int8))
        xs = torch.rand((m, 1), generator=g, device=dev) * 1e-2 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 1e-4
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(torch.bfloat16) if with_bias \
            else None
        moved = 1.0 * m * k + k * n + 2 * m * n + 4 * m + 4 * n + (2 * n if with_bias else 0)
        bound = max(2.0 * m * k * n / PEAK_INT8_OPS, moved / PEAK_BYTES_PER_S) * 1e3
        out.append((label, lambda xq=xq, xs=xs, kq=kq, ws=ws, bias=bias:
                    Q.w8a8_product(xq, xs, kq, ws, bias), bound, (m, n, k)))
    return out


def plan_of(lib, torch, m, n, k):
    """The variant's plan, with the splits the wrapper asks for (an older
    library's plan takes no splits: None)."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    if not hasattr(Q, "w8a8_splits"):
        return None
    splits = Q.w8a8_splits(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    plan = (ctypes.c_int * len(PLAN))()
    if lib.cgpt_w8a8_gemm_plan(m, n, k, splits, plan) != 0:
        return None
    return dict(zip(PLAN, plan))


def main() -> int:
    import torch

    from certifiedgpt_tpu_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda", 0)
    name_of_card = card()
    with tempfile.TemporaryDirectory() as tmp:
        built = build_variants(names, Path(tmp))
        shapes = cases(torch, dev)
        order = names + ["whole"] if "whole" in names and len(names) > 1 else names
        for turn, name in enumerate(order):
            lib, regs = built[name]
            cuda_kernels.build = lambda lib=lib: _Build(lib)
            print(f"[w8a8 bench] {name} (turn {turn + 1}): ptxas {regs}; {name_of_card}",
                  flush=True)
            for label, call, bound, (m, n, k) in shapes:
                call()
                torch.cuda.synchronize()
                ms = graph_ms(torch, call)
                plan = plan_of(lib, torch, m, n, k)
                l2 = ""
                if plan:
                    reads = plan["tiles"] * plan["k_steps_a_split"] * BLOCK_K * (
                        BLOCK_M + plan["tile_n"] / plan["cluster"])
                    l2 = (f", L2 reads {reads / ms / 1e9:.2f} TB/s (tile {plan['tile_n']}, "
                          f"{plan['stages']} stages, cluster {plan['cluster']}, "
                          f"{plan['blocks']} blocks, {plan['k_splits']} splits)")
                print(f"[w8a8 bench] {name} {label} [{m}, {k}] x [{k}, {n}]: {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f} % of the bound {bound:.4f} ms{l2}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
