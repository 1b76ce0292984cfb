#!/usr/bin/env python3
"""Where the time of the port's attention kernel goes, on one NVIDIA GPU.

Times the three wrappers of ``certifiedgpt_tpu_torch/ops/flash_attention.py``
at the ViT's shapes (mc_batch 96, 16 heads, 1024 patches + cls, head dim 88)
beside ``scaled_dot_product_attention``, first as built from
``certifiedgpt_tpu_torch/csrc/`` and then with parts of the kernel compiled
out: the tensor-core products, the softmax step, the copies into shared
memory, and pairs of them. A variant computes wrong values; only its time
means anything. What is left when two parts are out is the third part's time
alone, and the whole against the largest of them says how far the parts
overlap.

Each variant is a copy of the sources in a temporary directory with one edit
applied, built and timed in a process of its own:

    python3 scripts/bench_torch_attention.py            # all variants
    python3 scripts/bench_torch_attention.py whole no_softmax

Prints one line per variant with the card's name and power limit.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# a part is compiled out by making its function return at once
_NO_PRODUCTS = [(r"(uint64_t desc_b, int scale_d\) \{)", r"\1 return;"),
                (r"(?m)^( +uint64_t desc_b\) \{)", r"\1 return;")]
_NO_SOFTMAX = [(r"(float& corr0, float& corr1\) \{)", r"\1 return;")]
_NO_COPIES = [(r"(const void\* gmem, int bytes\) \{)", r"\1 return;")]
VARIANTS = {
    "whole": [],
    "no_products": _NO_PRODUCTS,
    "no_softmax": _NO_SOFTMAX,
    "no_copies": _NO_COPIES,
    "copies_only": _NO_PRODUCTS + _NO_SOFTMAX,
    "products_only": _NO_COPIES + _NO_SOFTMAX,
    "softmax_only": _NO_COPIES + _NO_PRODUCTS,
}


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


def time_variant(name: str) -> None:
    """Build the sources with the variant's edits from a temporary copy and
    time the wrappers (runs in a process of its own)."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        shutil.copytree(cuda_kernels.CSRC, csrc)
        header = csrc / "attention_common.cuh"
        text = header.read_text()
        for pattern, repl in VARIANTS[name]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise SystemExit(f"{name}: the edit {pattern!r} matched nothing")
        header.write_text(text)
        cuda_kernels.CSRC = csrc
        cuda_kernels.BUILD_DIR = Path(tmp) / "build"
        cuda_kernels.build()

        dev = torch.device("cuda")
        b, h, n, d = 96, 16, 1024, 88
        g = torch.Generator(device=dev).manual_seed(1)
        prem = torch.tensor([d ** -0.5 * FA.CLS_SPLIT_Q_PREMUL_LOG2E, 1.0, 1.0], device=dev)

        def fused(s):  # q, k, v as [B, H, S, D] views of one fused qkv product
            y = torch.randn((b, s, 3, h, d), generator=g, device=dev) * prem[None, None, :, None, None]
            y = y.to(torch.bfloat16)
            return [y[:, :, i].transpose(1, 2) for i in range(3)]

        qp, kp, vp = fused(n)
        qc, kc, vc = fused(1)
        q, k, v = fused(n + 1)
        qe, ke, ve = (t[:, :, :n].contiguous() for t in (q, k, v))
        cls_ms = cuda_ms(torch, lambda: FA.cls_split_attention_parts(qp, kp, vp, qc, kc, vc))
        flash_ms = cuda_ms(torch, lambda: FA.builtin_flash_attention_bhsd(q, k, v, d))
        even_ms = cuda_ms(torch, lambda: FA.builtin_flash_attention_bhsd(qe, ke, ve, d))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qe, ke, ve))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{name}: cls_split [96,16,1024,88]+cls {cls_ms:.3f} ms, flash [96,16,1025,88] views "
          f"{flash_ms:.3f} ms, flash [96,16,1024,88] contiguous {even_ms:.3f} ms, "
          f"scaled_dot_product_attention on the same {lib_ms:.3f} ms ({smi})", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        time_variant(sys.argv[2])
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; known: {', '.join(VARIANTS)}")
        subprocess.run([sys.executable, __file__, "--one", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
