#!/usr/bin/env python3
"""How many of a prefill's device operations a ``torch.profiler`` trace
holds, on one NVIDIA GPU, with the session's edges left bare and padded.

The prefill is ``models/llama.py::llama_apply`` at the certify chunk: a
Vicuna-7B-shaped decoder (32 layers, 4096 wide, W8A8 products, an int8 KV
cache) with seeded weights, 96 prompts of 96 positions into a 106-slot
cache. Each of ``--procs`` processes traces it ``--sessions`` times in each
form, in turns:

- ``bare``: a plain ``profile(activities=[CUDA])`` session;
- ``host_wait``: the same, the host waiting 50 ms after the session opens
  and before it closes;
- ``padded``: ``ops/cuda_kernels.py::device_trace``, spins of the card on
  both sides, left out by ``device_events``.

Prints one JSON line a process: each form's count a session, and the
count every session should show (the largest seen); with the card's name
and power limit:

    python3 scripts/probe_torch_trace_edges.py [--procs 3] [--sessions 10]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 96
PROMPT = 96
CACHE = 106  # seq_len 96 + max_new_tokens 10
FORMS = ("bare", "host_wait", "padded")


def measure(sessions: int) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from certifiedgpt_tpu_torch.models import llama as TLM
    from certifiedgpt_tpu_torch.models.model_zoo import _Init, _llama_params
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    device = torch.device("cuda")
    cfg = TLM.LlamaConfig(act_quant=True, kv_quant=True)
    params = _llama_params(_Init(0, device), cfg, True)
    cache = TLM.init_kv_cache(cfg, BATCH, CACHE, device)
    mask = torch.ones((BATCH, CACHE), dtype=torch.int32, device=device)
    x = torch.randn((BATCH, PROMPT, cfg.hidden_size), generator=torch.Generator(device=device)
                    .manual_seed(13), device=device).to(cfg.dtype)
    pos = torch.arange(PROMPT, device=device)[None].expand(BATCH, PROMPT)

    def prefill():
        TLM.llama_apply(params, cfg, x, mask, pos, cache, 0)

    def count(form):
        if form == "padded":
            with cuda_kernels.device_trace() as prof:
                prefill()
            return len(cuda_kernels.device_events(prof.events()))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if form == "host_wait":
                time.sleep(0.05)
            prefill()
            torch.cuda.synchronize()
            if form == "host_wait":
                time.sleep(0.05)
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)

    with torch.no_grad():
        for _ in range(2):
            prefill()
        counts = {form: [] for form in FORMS}
        for _ in range(sessions):
            for form in FORMS:
                counts[form].append(count(form))
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.sessions)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "card: not read", flush=True)
    whole = 0
    for proc in range(args.procs):
        done = subprocess.run([sys.executable, __file__, "--worker", "--sessions",
                               str(args.sessions)], capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stderr[-2000:], file=sys.stderr)
            return done.returncode
        counts = json.loads(done.stdout.strip().splitlines()[-1])
        whole = max(whole, *(max(v) for v in counts.values()))
        short = {form: sum(1 for n in v if n < whole) for form, v in counts.items()}
        print(json.dumps({"process": proc, "whole": whole, "sessions_short": short,
                          "counts": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
