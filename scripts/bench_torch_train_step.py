#!/usr/bin/env python3
"""A train step of the shipped VQAv2 finetuning configs at full width on one
GPU, for each checkout given, each in a process of its own, in turns:

    python3 scripts/bench_torch_train_step.py output/parent_tree . . output/parent_tree

For each checkout (its ``certifiedgpt_tpu_torch`` imported from it, its
kernels built into its own ``build/``), a process writes the VQAv2-shaped
set of ``chip_smoke.py``'s phase 11 (seeded 640x480 JPEGs), builds the
finetune agent of ``configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml``
and then of ``vqav2_finetuning_noise_0.5.yaml`` (seeded weights; the model
block's checkpoint paths where nothing exists) and on one packed batch of
48 samples (16 rows x 256 tokens) takes ``WARM`` steps, times ``TIMED``
more (``FinetuneAgent._train_step``: noise, forward, backward, AdamW; each
synchronized; the median), reads the peak device memory, then traces one
step's forward and backward by kernel group (``chip_smoke.train_step_groups``,
from this script's checkout). Each process prints one ``RESULT`` line of
JSON; the script prints them all at the end with the card's name and power
limit. Compare checkouts only within one call: the card's clocks and the
shared host differ from call to call.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CONFIGS = (("w8a8", "configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml"),
           ("bf16", "configs/train_configs/vqav2_finetuning_noise_0.5.yaml"))
WARM = 2
TIMED = 5


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its functions import
    the package lazily, so they use whichever checkout is on the path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one(root: str) -> dict:
    """The measurements of one checkout, in this process."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from unittest import mock

    import certifiedgpt_tpu_torch

    if not certifiedgpt_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {certifiedgpt_tpu_torch.__file__}, not {root}'s package")
    from certifiedgpt_tpu_torch import registration  # noqa: F401 (the agents)
    from certifiedgpt_tpu_torch.agents.base import setup_agent
    from certifiedgpt_tpu_torch.common.config import Config

    smoke = load_smoke()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    with tempfile.TemporaryDirectory(prefix="bench_train_step_") as tmp:
        data = Path(tmp)
        env = smoke.write_train_set(data)
        for kind, path in CONFIGS:
            with mock.patch.dict(os.environ, dict(env, OUTPUT_DIR=str(data / f"out_{kind}"))):
                agent = setup_agent(Config(path), device=device)
                host = next(iter(agent.create_loaders()["train"]))
            batch = agent.device_batch(host)
            gen = torch.Generator(device=device).manual_seed(0)
            for _ in range(WARM):
                agent._train_step(batch, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(TIMED):
                t0 = time.perf_counter()
                agent._train_step(batch, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 1e9
            groups = smoke.train_step_groups(torch, agent.model, agent.model.cfg, batch)
            step = sorted(times)[len(times) // 2]
            out[kind] = {"step_s": step, "steps_s": times,
                         "samples_per_s": batch["image"].shape[0] / step, "peak_gb": peak,
                         "trace": groups}
            print(f"[train-step] {root} {kind}: {step:.4f} s a step (median of {TIMED}; "
                  f"{', '.join(f'{t:.4f}' for t in times)}), peak {peak:.2f} GB; "
                  f"{smoke.format_groups(groups)}", flush=True)
            del agent, batch
            torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        results += [json.loads(line[7:]) for line in proc.stdout.splitlines()
                    if line.startswith("RESULT ")]
    print(f"card: {card.strip()}")
    for r in results:
        print(f"{r['root']}: " + ", ".join(
            f"{kind} {r[kind]['step_s']:.4f} s a step, {r[kind]['samples_per_s']:.2f} samples/s, "
            f"peak {r[kind]['peak_gb']:.2f} GB, device forward "
            f"{r[kind]['trace']['forward']['device']:.4f} s / backward "
            f"{r[kind]['trace']['backward']['device']:.4f} s" for kind, _ in CONFIGS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
