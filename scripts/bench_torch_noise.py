#!/usr/bin/env python3
"""Where the time of the port's noise kernel goes, on one NVIDIA GPU.

Times the noise kernel (``certifiedgpt_tpu_torch/csrc/noise.cu``) at the
main path's shape, 96 noisy copies of a 448x448x3 f32 image at sigma 0.5,
first as built from the source and then with one part compiled out: the
Philox rounds (the per-pair and per-image words are fed through), the
transform (log, sqrt, cos), the stores, or all but the loads and stores; and
the design's alternatives. A variant computes wrong values; only its time
means anything.

Each variant is a copy of ``noise.cu`` with its edits applied, built by
``nvcc`` into a library of its own; all builds run in parallel, then every
variant is timed through the package's launch function in one process, in
turns, so that their times compare on one card:

    python3 scripts/bench_torch_noise.py            # all variants
    python3 scripts/bench_torch_noise.py whole no_stores

Prints one line per variant with the card's name and power limit, the
kernel's time, its share of the byte bound (3.35 TB/s), ptxas' registers and
the variant's SASS instructions by class (``sass_count.py``): one trip of
the image loop (eight elements of one image), an element's share of it and
the time those take at 128 instructions a clock an SM (the issue rate, at
the card's highest SM clock as ``nvidia-smi`` reads it; not a bound).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import sass_count  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12
N_IMAGES, IMAGE_HWC, SIGMA = 96, (448, 448, 3), 0.5

# Edits of the kernel that csrc/noise.cu holds (a thread owns four pairs and
# walks through the images of its block). A stored value is replaced by a
# compare that the compiler cannot resolve, so the work that feeds it stays.
_NO_PHILOX = [(r"(uint4 philox_rest\([\s\S]*?\[7\]\) \{)",
               r"\1 return make_uint4(hi_a ^ w.x ^ k0[0], lo_a ^ w.y, hi_a ^ w.z ^ k1[0], lo_a ^ w.w);")]
_NO_TRANSFORM = [(r"(float minus_gaussian\(uint32_t bits1, uint32_t bits2\) \{)",
                  r"\1 return __uint_as_float((bits1 >> 9) | 0x3F800000u) - "
                  r"__uint_as_float((bits2 >> 9) | 0x3F800000u);")]
_NO_STORES = [(r"(__stcs\(reinterpret_cast<float4\*>)",
               r"if (v[0] + v[1] + v[2] + v[3] == 12345.f) \1")]
_LOADS_STORES_ONLY = [(r"minus_gaussian\(c\.[xz], c\.[yw]\)", "1.0f")]
_PLAIN_STORES = [(r"__stcs\(reinterpret_cast<float4\*>\(o \+ e\), (make_float4\([^;]*\))\);",
                  r"*reinterpret_cast<float4*>(o + e) = \1;")]
# the transform on the library's full-precision functions
_EXACT_MATH = [(r"const float r = sqrt_approx\([^;]*;\s*return r \* cos_approx\([^;]*;",
                "return -sqrtf(-2.0f * logf(2.0f - f1)) * cosf(kTwoPi * (2.0f - f2));")]
VARIANTS = {
    "whole": [],
    "no_philox": _NO_PHILOX,
    "no_transform": _NO_TRANSFORM,
    "no_stores": _NO_STORES,
    "loads_stores_only": _LOADS_STORES_ONLY,
    # the design's alternatives: the transform's library functions, the
    # element path (odd image sizes) at this size, stores without the
    # streaming hint, 4 or 12 images a block, two trips of the image loop
    # interleaved
    "exact_math": _EXACT_MATH,
    "images4": [(r"kImagesPerBlock = 8;", "kImagesPerBlock = 4;")],
    "element_path": [(r"const bool vec = ", "const bool vec = false && ")],
    "plain_stores": _PLAIN_STORES,
    "loads_plain_stores_only": _LOADS_STORES_ONLY + _PLAIN_STORES,
    "images12": [(r"kImagesPerBlock = 8;", "kImagesPerBlock = 12;")],
    "unroll2": [(r"#pragma unroll 1\n", "#pragma unroll 2\n")],
}


# the package's library defines this entry in row_quant.cu; a variant's
# library is built from noise.cu alone
_ERROR_STRING = """
extern "C" const char* cgpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, iters=50, warmup=5):
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
    """Edit and compile ``noise.cu`` once per variant, all in parallel;
    returns {name: (library, ptxas register lines, (one trip of the image
    loop by class, SASS instructions an element))}."""
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    source = (cuda_kernels.CSRC / "noise.cu").read_text()
    procs = {}
    for name in names:
        text = source
        for pattern, repl in VARIANTS[name]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise SystemExit(f"{name}: the edit {pattern!r} matched nothing")
        unit = tmp / f"{name}.cu"
        unit.write_text(text + _ERROR_STRING)
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
        lib.cgpt_noisy_tile.argtypes = cuda_kernels._SIGNATURES["cgpt_noisy_tile"]
        lib.cgpt_noisy_tile.restype = ctypes.c_int
        lib.cgpt_error_string.argtypes = (ctypes.c_int,)
        lib.cgpt_error_string.restype = ctypes.c_char_p
        regs = [line.split("ptxas info    : ")[-1] for line in out.splitlines() if "Used" in line]
        built[name] = (lib, regs, sass_count.noise_trip(path))
    return built


def main() -> int:
    import torch

    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import noise as N

    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; known: {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(IMAGE_HWC, generator=g, device=dev)
    sig = torch.tensor(SIGMA, dtype=torch.float32, device=dev)
    seed = torch.tensor([12345, 67890], dtype=torch.int32, device=dev)
    elems = N_IMAGES * x.numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sass_count.max_sm_clock_mhz()
    moved = 4.0 * (x.numel() + elems)
    bound = moved / PEAK_BYTES_PER_S * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        built = build_variants(names, Path(tmp))
        times = {}
        for _ in range(2):  # two rounds, variants in turns
            for name in names:
                cuda_kernels.build = lambda lib=built[name][0]: _Build(lib)
                times.setdefault(name, []).append(
                    cuda_ms(torch, lambda: N._launch_noise(x, N_IMAGES, sig, seed)))
        # a yardstick of the card's write rate: PyTorch filling a tensor of
        # the output's size (writes only)
        out = torch.empty((N_IMAGES,) + IMAGE_HWC, device=dev)
        fill_ms = min(cuda_ms(torch, lambda: out.fill_(SIGMA)) for _ in range(2))
    print(f"fill_ of the output's {4 * elems / 1e6:.1f} MB: {fill_ms:.4f} ms "
          f"({100 * 4 * elems / PEAK_BYTES_PER_S * 1e3 / fill_ms:.0f} % of its byte bound) "
          f"({smi})", flush=True)
    for name in names:
        ms = min(times[name])
        _, regs, (trip, per_elem) = built[name]
        issue = sass_count.issue_ms(per_elem, elems, sms, clock)
        print(f"{name}: {ms:.4f} ms ({100 * bound / ms:.0f} % of the byte bound {bound:.4f} ms; "
              f"rounds {', '.join(f'{t:.4f}' for t in times[name])}) "
              f"[ptxas: {'; '.join(r for r in regs if r)}] "
              f"[SASS: {per_elem:.2f} an element, issue {issue:.4f} ms; one trip "
              f"{json.dumps(trip)}] ({smi}; highest SM clock {clock:.0f} MHz, {sms} SMs)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
