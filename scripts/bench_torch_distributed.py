#!/usr/bin/env python3
"""What ``run.distributed`` and the profiler cost a certified image, on one GPU.

Runs ``chip_smoke.py`` phase 8's certify run of one image (the shipped
``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` at full width over
the script's written files and seeded weights, ``max_images`` 1) three ways,
each in a fresh process through ``chip_smoke.py``'s one-rank worker
(``--phase15-worker``, ``launch.main`` between the launch counters):

- ``plain``: one process, no process group;
- ``distributed``: ``python -m torch.distributed.run --standalone
  --nproc_per_node 1``, ``run.distributed`` (NCCL at world size 1: the
  token gather of every chunk);
- ``profiled``: the same with ``enable_profile`` on image 0 for phase
  15.1's window.

in the order plain, distributed, profiled, profiled, distributed, plain
(one pair of passes), so drift shows. Prints each run's row
seconds (and, when profiled, the trace's stop-and-export seconds inside
them), checks that every run's row (label, radius, draws) is the same, and
prints the card's name and power limit. Run from the repository root:

    python3 scripts/bench_torch_distributed.py
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402

MODES = ("plain", "distributed", "profiled")
#: the order of the runs: each mode once forwards and once backwards
ORDER = MODES + MODES[::-1]


def run_once(mode: str, root: Path, env: dict, base_cfg: dict, index: int) -> dict:
    out = root / f"out_{mode}_{index}"
    cfg = json.loads(json.dumps(base_cfg))
    cfg["run"].update(max_images=1, output_dir=str(out), distributed=mode != "plain")
    if mode == "profiled":
        cfg["run"].update(enable_profile=True, profile_step=0,
                          duration_ms=C.PROFILE_WINDOW_MS,
                          profile_logdir=str(root / f"trace_{index}"))
    path = root / f"certify_{mode}_{index}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    spec = {"argv": ["certify", "--config-path", str(path), "--device", "cuda"],
            "result": str(root / f"worker_{mode}_{index}.json")}
    worker = [os.path.join(REPO, "chip_smoke.py"), "--phase15-worker", json.dumps(spec)]
    if mode == "plain":
        cmd = [sys.executable] + worker
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1"] + worker
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=dict(os.environ, **env), capture_output=True, text=True,
                          timeout=900, cwd=REPO)
    command_s = time.perf_counter() - t0
    if proc.returncode != 0:
        C.fail(f"{mode}: exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    row = C.read_rows(out / "certify_results.jsonl")[0]
    log_text = (out / "certified.log").read_text()
    export = re.search(r"\(stop and export ([0-9.]+) s\)", log_text)
    res = json.loads(Path(spec["result"]).read_text())
    return {"mode": mode, "seconds": row["seconds"], "row": (row["label"], row["radius"],
                                                              row["draws"]),
            "export_s": float(export.group(1)) if export else None,
            "launch_main_s": res["wall"], "command_s": command_s,
            "decode_steps": res["decode_steps"]}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    import torch
    from unittest import mock

    from certifiedgpt_tpu_torch.common.config import Config

    card = C.phase_device(torch)
    C.phase_build()
    results = []
    with tempfile.TemporaryDirectory(prefix="bench_dist_") as tmp:
        root = Path(tmp)
        env, _ = C.launch_files(root, C.LAUNCH_IMAGES, 768, 4096)
        env["OUTPUT_DIR"] = str(root / "out")
        with mock.patch.dict(os.environ, env):
            base_cfg = Config(os.path.join(REPO, C.LAUNCH_RUNS[0][1])).to_dict()
        for index, mode in enumerate(ORDER):
            res = run_once(mode, root, env, base_cfg, index)
            results.append(res)
            extra = "" if res["export_s"] is None else \
                f", the trace's stop and export {res['export_s']:.3f} s of it"
            print(f"[bench] run {index} {mode:11s}: {res['seconds']:.3f} s for the certified "
                  f"image{extra}; launch.main {res['launch_main_s']:.3f} s, command "
                  f"{res['command_s']:.3f} s; {res['decode_steps']} decode steps; {card}",
                  flush=True)
    rows = {r["row"] for r in results}
    if len(rows) != 1:
        C.fail(f"the runs' rows differ: {rows}")
    for mode in MODES:
        secs = [r["seconds"] for r in results if r["mode"] == mode]
        print(f"[bench] {mode:11s}: {' '.join(f'{s:.3f}' for s in secs)} s an image "
              f"(mean {sum(secs) / len(secs):.3f})", flush=True)
    print(json.dumps({"card": card, "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
