#!/usr/bin/env python3
"""Time the f32 int8 paths and a lone bf16 query row of two checkouts of the
port on one NVIDIA GPU, in turns, so that their times compare on one card.

Each tree given runs in a process of its own (its package imported from that
tree, its kernels built from its own ``csrc/``), in the order given, e.g.
parent, change, change, parent:

    python3 scripts/bench_torch_f32_paths.py output/parent_tree . . output/parent_tree

Cases, each called through the package's wrappers on the same seeded inputs:
the weight-only int8 product on f32 x (``int8_weight_forward``) at a decode
layer's shapes at 96 rows, the prefill's down_proj at 9216 rows and against
the upcast plus cuBLAS (TF32 off); the f32 prefill's attention with its
cache write (``prefill_attention_kv8``) at the certify prefill (q [96, 96,
32, 128], 96 new rows into 106 slots), eval's ([8, 320, 32, 128] over 330)
and a 2048-slot cache at offset 1900, with the decoder's causal mask; and
``multi_head_attention_kv8`` of a lone bf16 query row at the certify batch
over 106 slots. Each is timed eagerly (CUDA events, the mean of 20 calls
after a warm-up) and replayed from a CUDA graph. Prints one JSON line a
tree and case, and the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = ("weight 96x4096x4096", "weight 96x4096x11008", "weight 96x11008x4096",
         "weight 9216x11008x4096", "prefill certify", "prefill eval", "prefill 2048",
         "lone bf16 row")


def worker(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(18)

    def eager_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def graph_ms(fn, iters=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return eager_ms(graph.replay, iters)

    def report(case, fn, **extra):
        print(json.dumps({"tree": tree, "case": case, "ms": eager_ms(fn),
                          "graph_ms": graph_ms(fn), **extra}), flush=True)

    for case in CASES[:4]:
        m, k, n = (int(v) for v in case.split()[1].split("x"))
        x = torch.randn((m, k), generator=g, device=dev)
        kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                                dtype=torch.int8))
        scale = torch.rand(n, generator=g, device=dev) * 1e-3
        report(case, lambda: Q.int8_weight_forward(x, kq, scale),
               upcast_cublas_ms=eager_ms(lambda: Q._int8_weight_forward_plain(x, kq, scale)))
        del x, kq
    for case, (b, s, t, off) in zip(CASES[4:7], ((96, 96, 106, 0), (8, 320, 330, 0),
                                                 (8, 96, 2048, 1900))):
        q, k, v = (torch.randn((b, s, 32, 128), generator=g, device=dev) for _ in range(3))
        kc, ksc = Q._quantize_rows_plain(torch.randn((b, t, 32, 128), generator=g, device=dev))
        vc, vsc = Q._quantize_rows_plain(torch.randn((b, t, 32, 128), generator=g, device=dev))
        cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}
        pos = off + torch.arange(s, device=dev)[:, None]
        mask = (torch.arange(t, device=dev)[None, :] <= pos)[None, None].expand(b, 1, s, t)
        report(case, lambda: A.prefill_attention_kv8(q, k, v, cache, off, mask))
        del q, k, v, cache, kc, vc
    q = torch.randn((96, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
    kc, ksc = Q._quantize_rows_plain(torch.randn((96, 106, 32, 128), generator=g, device=dev))
    vc, vsc = Q._quantize_rows_plain(torch.randn((96, 106, 32, 128), generator=g, device=dev))
    mask = torch.ones((96, 1, 1, 106), dtype=torch.bool, device=dev)
    report(CASES[7], lambda: A.multi_head_attention_kv8(q, kc, ksc, vc, vsc, mask))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        return 0
    trees = sys.argv[1:] or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
