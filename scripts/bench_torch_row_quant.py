#!/usr/bin/env python3
"""Where the time of the port's two row-quant kernels goes, on one NVIDIA GPU.

Times ``ln_quant_rows`` at [98304, 1408] and ``gelu_quant_rows`` at
[98304, 6144] (the EVA ViT-g's qkv/fc1 and fc2 inputs at mc_batch 96), on
N(0, 1) and N(0, 3^2) inputs, first as built from
``certifiedgpt_tpu_torch/csrc/row_quant.cu`` and then with one part of the
kernels compiled out: the transform (the LayerNorm arithmetic, or the GELU),
the LayerNorm's mean and variance passes, the warp reductions, the division
and rounding, the stores, or all but the bulk copies of the rows. A variant
computes wrong values; only its time means anything.

Each variant is a copy of ``row_quant.cu`` with its edits applied, built by
``nvcc`` into a library of its own; all builds run in parallel, then every
variant is timed through the package's wrappers in one process, in turns, so
that their times compare on one card:

    python3 scripts/bench_torch_row_quant.py            # all variants
    python3 scripts/bench_torch_row_quant.py whole no_stores

Prints one line per variant and kernel with the card's name and power limit,
the kernel's time on each input, its share of the byte bound (3.35 TB/s) and
ptxas' registers of the variant.
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
ROWS = 96 * 1024
LN_WIDTH, GELU_WIDTH = 1408, 6144

# Edits of the kernels that csrc/row_quant.cu holds (persistent blocks, one
# warp a row, rows brought into shared memory by bulk copies). A stored value
# is replaced by a compare that the compiler cannot resolve, so the work that
# feeds it stays.
_NO_TRANSFORM = [
    (r"(float ln_affine\(float x, float mean, float rs, float g, float b\) \{)", r"\1 return x;"),
    (r"(float gelu_as\(float x\) \{)", r"\1 return x;"),
]
_NO_STATISTICS = [  # the LayerNorm's mean and variance passes
    (r"const float (mean|var) = __fdiv_rn\(warp_sum\([^;]*\), k\);", r"const float \1 = k;"),
]
_NO_SHUFFLES = [
    (r"(float warp_sum\(float v\) \{)", r"\1 return v;"),
    (r"(float warp_max\(float v\) \{)", r"\1 return v;"),
]
_NO_DIVISION = [(r"(uint32_t code_fast\(float h, float inv, bool& near\) \{)",
                 r"\1 return __float_as_uint(h);")]
_NO_STORES = [
    (r"(\*reinterpret_cast<uint(32_t|2)\*>\(dst\) = )", r"if (v[0] == 0x12345678u) \1"),
    (r"if \(team\.tid == 0\) \*srow = xs;", "if (team.tid == 0 && xs == 3.f) *srow = xs;"),
]
_LOADS_ONLY = [(r"(ln|gelu)_row\(buf, [^;]*\);", "")]  # the copies and waits stay
VARIANTS = {
    "whole": [],
    "no_transform": _NO_TRANSFORM,
    "no_statistics": _NO_STATISTICS,
    "no_shuffles": _NO_SHUFFLES,
    "no_division": _NO_DIVISION,
    "no_stores": _NO_STORES,
    "loads_only": _LOADS_ONLY,
    # the design's alternatives: a deeper LayerNorm ring, GELU rows of one warp
    "ln_ring4": [(r"kLnStages = 2;", "kLnStages = 4;")],
    "gelu_warp_rows": [(r"kGeluTeamWarps = 4;", "kGeluTeamWarps = 1;")],
}
# variants that change one kernel only
ONLY = {"no_statistics": "ln_quant_rows", "ln_ring4": "ln_quant_rows",
        "gelu_warp_rows": "gelu_quant_rows"}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, iters=20, warmup=3):
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


class _Build:
    """What the wrappers read from ``cuda_kernels.build()``: the library."""

    def __init__(self, lib):
        self.lib = lib


def build_variants(names, tmp: Path):
    """Edit and compile ``row_quant.cu`` once per variant, all in parallel;
    returns {name: (library, ptxas register lines)}."""
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    source = (cuda_kernels.CSRC / "row_quant.cu").read_text()
    procs = {}
    for name in names:
        text = source
        for pattern, repl in VARIANTS[name]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise SystemExit(f"{name}: the edit {pattern!r} matched nothing")
        unit = tmp / f"{name}.cu"
        unit.write_text(text)
        lib = tmp / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-shared", str(unit), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(path))
        for entry in ("cgpt_ln_quant", "cgpt_gelu_quant"):
            fn = getattr(lib, entry)
            fn.argtypes = cuda_kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        lib.cgpt_error_string.argtypes = (ctypes.c_int,)
        lib.cgpt_error_string.restype = ctypes.c_char_p
        regs = [line.split("ptxas info    : ")[-1] for line in out.splitlines() if "Used" in line]
        built[name] = (lib, regs)
    return built


def main() -> int:
    import torch

    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import quantization as Q

    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; known: {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        built = build_variants(names, Path(tmp))
        scale = (1.0 + 0.1 * torch.randn(LN_WIDTH, generator=g, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(LN_WIDTH, generator=g, device=dev)).to(torch.bfloat16)
        cases = []  # (kernel, std, call, bytes moved)
        for std in (1.0, 3.0):
            x_ln = (torch.randn((ROWS, LN_WIDTH), generator=g, device=dev) * std).to(torch.bfloat16)
            cases.append(("ln_quant_rows", std, lambda x=x_ln: Q.ln_quant_rows(x, scale, bias, 1e-6),
                          ROWS * LN_WIDTH * 3 + ROWS * 4 + LN_WIDTH * 4))
        for std in (1.0, 3.0):
            x_g = (torch.randn((ROWS, GELU_WIDTH), generator=g, device=dev) * std).to(torch.bfloat16)
            cases.append(("gelu_quant_rows", std, lambda x=x_g: Q.gelu_quant_rows(x),
                          ROWS * GELU_WIDTH * 3 + ROWS * 4))
        times = {}
        for _ in range(2):  # two rounds, variants in turns
            for name in names:
                cuda_kernels.build = lambda lib=built[name][0]: _Build(lib)
                for kernel, std, call, _moved in cases:
                    times.setdefault((name, kernel, std), []).append(cuda_ms(torch, call))
    for name in names:
        for kernel in ("ln_quant_rows", "gelu_quant_rows"):
            if ONLY.get(name, kernel) != kernel:
                continue
            parts = []
            for _k, std, _c, moved in (c for c in cases if c[0] == kernel):
                ms = min(times[(name, kernel, std)])
                bound = moved / PEAK_BYTES_PER_S * 1e3
                parts.append(f"N(0,{std:g}^2) {ms:.4f} ms ({100 * bound / ms:.0f} % of the "
                             f"byte bound {bound:.4f} ms)")
            regs = "; ".join(r for r in built[name][1] if r)
            print(f"{name}: {kernel} {', '.join(parts)} [ptxas: {regs}] ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
