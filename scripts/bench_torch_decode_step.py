#!/usr/bin/env python3
"""One decode step of the full-width int8 decoder on one NVIDIA GPU, from
one or more checkouts of the repository, in turns.

The step is ``models/llama.py::llama_apply`` at the certify decode: a
Vicuna-7B-shaped decoder (32 layers, 4096 wide, weight-only int8 products,
an int8 KV cache) with seeded weights, 96 rows, one token each at slot 96
of a 106-slot cache, the slot given as an int. For each checkout, in a
process of its own (each imports its own ``certifiedgpt_tpu_torch``),
prints the step's device operations (``torch.profiler``), its time
replayed from a CUDA graph (the card alone) and eager, and the host's
milliseconds to launch it from an idle card; where the checkout has them,
the same step with the slot as a 0-dim int32 tensor on the card (eager and
from a graph), and ``generate``'s whole step (``models/minigpt4.py``:
embedding, decoder at the device slot, lm_head, the greedy choice and the
output's column) captured as ``generate`` captures it: its replay's device
ms (with the reset of the step index before it) and the host's ms to
launch a replay; with the card's name and power limit:

    python3 scripts/bench_torch_decode_step.py                 # this checkout
    python3 scripts/bench_torch_decode_step.py OLD . . OLD     # two, in turns

Compare two checkouts only within one call: calls land on cards whose
clocks differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 96
PROMPT = 96  # the step's cache slot
CACHE = 106  # seq_len 96 + max_new_tokens 10


def measure(root: str) -> dict:
    """The step's figures for the checkout at ``root`` (run in a fresh process)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from certifiedgpt_tpu_torch.models import llama as TLM
    from certifiedgpt_tpu_torch.models.model_zoo import _Init, _llama_params

    device = torch.device("cuda")
    cfg = TLM.LlamaConfig(act_quant=True, kv_quant=True)
    params = _llama_params(_Init(0, device), cfg, True)
    cache = TLM.init_kv_cache(cfg, BATCH, CACHE, device)
    mask = torch.ones((BATCH, CACHE), dtype=torch.int32, device=device)
    x = torch.randn((BATCH, 1, cfg.hidden_size), generator=torch.Generator(device=device)
                    .manual_seed(1), device=device).to(cfg.dtype)
    pos = torch.full((BATCH, 1), PROMPT, dtype=torch.int32, device=device)

    def step():
        TLM.llama_apply(params, cfg, x, mask, pos, cache, PROMPT)

    def device_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    eager_ms = device_ms(step, 5)
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph_ms = device_ms(graph.replay, 10)
    out = {"device_operations": ops, "graph_ms": graph_ms, "eager_ms": eager_ms,
           "host_launch_ms": min(host_ms)}
    from certifiedgpt_tpu_torch.models import minigpt4 as TM

    if not hasattr(TM, "_decode_step"):  # a checkout before the device slot
        return out
    from certifiedgpt_tpu_torch.common.graphs import GraphStore

    slot = torch.tensor(PROMPT, dtype=torch.int32, device=device)

    def slot_step():
        TLM.llama_apply(params, cfg, x, mask, pos, cache, slot)

    out["slot_eager_ms"] = device_ms(slot_step, 5)
    with torch.cuda.stream(side):
        slot_step()
    torch.cuda.current_stream().wait_stream(side)
    slot_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(slot_graph):
        slot_step()
    out["slot_graph_ms"] = device_ms(slot_graph.replay, 10)

    mcfg = TM.MiniGPT4Config(llama=cfg)
    knobs = TM._Knobs(2, 0, False, 1.0, 0.9, 1, 1.0)
    st = TM._DecodeState(mcfg, BATCH, PROMPT, CACHE - PROMPT, knobs, device)
    st.positions.fill_(PROMPT)
    kept = [x.clone() for x in st.small()]

    def restore():
        for x, was in zip(st.small(), kept):
            x.copy_(was)

    GraphStore().capture(st, lambda: TM._decode_step({"llama": params}, mcfg, st, knobs, None),
                         restore, device)

    def replay():
        st.t.zero_()
        st.graph.replay()

    out["generate_step_graph_ms"] = device_ms(replay, 10)
    replay_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.graph.replay()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        st.t.zero_()
    torch.cuda.synchronize()
    out["generate_step_host_ms"] = min(replay_ms)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--worker", root], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"decode step, {root}: {r['device_operations']} device operations, "
              f"{r['graph_ms']:.3f} ms from a CUDA graph, {r['eager_ms']:.3f} ms eager, the host "
              f"launches it in {r['host_launch_ms']:.2f} ms ({card})", flush=True)
        if "slot_eager_ms" in r:
            print(f"decode step, {root}, the slot on the card: {r['slot_graph_ms']:.3f} ms from a "
                  f"CUDA graph, {r['slot_eager_ms']:.3f} ms eager; generate's captured step "
                  f"(lm_head, the choice, the output column included) "
                  f"{r['generate_step_graph_ms']:.3f} ms a replay, the host launches a replay "
                  f"in {r['generate_step_host_ms']:.3f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
