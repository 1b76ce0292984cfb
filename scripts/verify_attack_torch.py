#!/usr/bin/env python
"""Attack-number validation runbook of the PyTorch port, the twin of
``scripts/verify_attack.py``: one command to discharge the attack-ASR
clause of BASELINE.md the day real CLIP surrogate + victim checkpoints are
mounted, with the port's attack agent (``certifiedgpt_tpu_torch/attack/``)
on ``--device`` (the card by default, which must be there).

The comparison against BASELINE.md (``compare_summary``), the surrogate
check (``missing_surrogates``) and the synthetic config are copies of the
JAX runbook's, so a summary of either package's agent (same keys) is read
the same way:

  python scripts/verify_attack_torch.py                 # full run + compare
  python scripts/verify_attack_torch.py --images 20     # quick pass
  python scripts/verify_attack_torch.py --summary out/attack_summary.json
                                                        # compare an existing run
  python scripts/verify_attack_torch.py --synthetic --device cpu
                                                        # tiny random-weight
                                                        # dry run of the whole
                                                        # command path (no
                                                        # checkpoints needed)

Surrogate checkpoint paths come from the config's env-var defaults
(CLIP_VIT_B16/…, see ``configs/attack_configs/vqav2_attack.yaml``);
backbones whose path is missing run on seeded random weights and their
cells are reported as SKIPPED (structurally exercised, numerically
undischarged) instead of failed. Exit code 0 when the report is ok, 1 with
``failed`` or ``undischarged`` on stderr otherwise; ``main`` returns the
report. Plumbing is tested in ``tests/test_torch_verify_attack.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from certifiedgpt_tpu_torch import registration  # noqa: E402,F401
from certifiedgpt_tpu_torch.agents.base import setup_agent  # noqa: E402
from certifiedgpt_tpu_torch.common.config import Config  # noqa: E402
from certifiedgpt_tpu_torch.common.logging import setup_logger  # noqa: E402

# BASELINE.md "Targeted black-box attack success rate" table
# (the reference's README.md:114-118), keyed by the shipped config's
# backbone names x sigma grid
BASELINE_ASR = {
    "rn50": {"0.0": 0.585, "0.25": 0.583, "0.5": 0.579, "1.0": 0.579},
    "rn101": {"0.0": 0.562, "0.25": 0.554, "0.5": 0.551, "1.0": 0.552},
    "vit_b16": {"0.0": 0.595, "0.25": 0.587, "0.5": 0.583, "1.0": 0.581},
    "vit_b32": {"0.0": 0.620, "0.25": 0.623, "0.5": 0.620, "1.0": 0.620},
    "vit_l14": {"0.0": 0.470, "0.25": 0.454, "0.5": 0.449, "1.0": 0.448},
}
# ANCOVA headline (the reference's README.md:160): the
# smoothing-interaction coefficient is significantly NEGATIVE
BASELINE_ANCOVA = {"coef": -0.0090, "p_max": 0.001}


def compare_summary(
    summary: dict,
    tol: float = 0.05,
    random_backbones=(),
    baseline: dict = None,
) -> dict:
    """Per-cell comparison of an ``attack_summary.json`` against the
    reference table. A cell passes when |measured - reference| <= tol
    (the published rates are 100-image-scale estimates; tol=0.05 is
    ~2 binomial standard errors at that scale). Cells of backbones that
    ran with RANDOM surrogate weights (no checkpoint mounted) are
    SKIPPED, not failed — the report lists exactly which clauses remain
    undischarged, mirroring ``verify_checkpoints.py``. So is the ANCOVA
    when every backbone of the summary ran with random weights."""
    baseline = BASELINE_ASR if baseline is None else baseline
    grid = summary.get("success_rate_grid") or {}
    if not grid and "success_rate_per_backbone" in summary:
        # single-sigma run: compare against that sigma's column only
        sig = str(float(summary["sigma_grid"][0]))
        grid = {
            name: {sig: rate}
            for name, rate in summary["success_rate_per_backbone"].items()
        }
    # sigma cells are keyed by str() of whatever the config carried —
    # a YAML `sigma_grid: [0, 1]` yields '0'/'1' while the baseline
    # table uses '0.0'/'1.0'. Normalize BOTH sides through str(float())
    # so a formatting mismatch can't silently downgrade cells to
    # 'skipped' while the report still says ok.
    grid = {
        name: {str(float(s)): r for s, r in row.items()}
        for name, row in grid.items()
    }
    cells, skipped = [], []
    for name, ref_row in baseline.items():
        for sig, ref_rate in ref_row.items():
            sig = str(float(sig))
            measured = (grid.get(name) or {}).get(sig)
            cell = {
                "backbone": name,
                "sigma": sig,
                "reference": ref_rate,
                "measured": measured,
            }
            if name in random_backbones or measured is None:
                cell["status"] = "skipped"
                cell["why"] = (
                    "surrogate ran with random weights"
                    if name in random_backbones else "cell not in summary"
                )
                skipped.append(cell)
            else:
                cell["status"] = (
                    "ok" if abs(measured - ref_rate) <= tol else "FAIL"
                )
                cells.append(cell)
    anc = (summary.get("ancova") or {}).get("coefficients", {})
    # the reference's headline is the smoothing x RN101 interaction
    # (ref README.md:160); fall back to the sigma main effect when the
    # run's backbone set lacks rn101
    term = anc.get("sigma:backbone[rn101]") or anc.get("sigma") or {}
    coef = term.get("estimate")
    pval = term.get("p_value")
    ancova_row = {
        "reference": BASELINE_ANCOVA,
        "measured": {"coef": coef, "p": pval},
    }
    # the backbones whose rows the summary holds: the grid's, the
    # per-backbone rates' and those the ANCOVA's terms name
    ran = set(grid) | set(summary.get("success_rate_per_backbone") or {}) | {
        name.split("[", 1)[1][:-1] for name in anc if name.endswith("]")
    }
    if coef is None or pval is None:
        ancova_row["status"] = "skipped"
    elif ran and ran <= set(random_backbones):
        # a regression over surrogates that all ran with random weights
        # says nothing of the reference's claim: skipped, as their cells
        # are (the JAX runbook fails it unless it comes out negative)
        ancova_row["status"] = "skipped"
        ancova_row["why"] = "every surrogate ran with random weights"
    else:
        # the discharge criterion is the reference's CLAIM — a
        # significantly negative smoothing effect — not the exact
        # coefficient (it depends on the sampled images)
        ancova_row["status"] = (
            "ok" if (coef < 0 and pval <= 0.05) else "FAIL"
        )
    failed = [c for c in cells if c["status"] == "FAIL"]
    return {
        "tol": tol,
        "cells": cells + skipped,
        "ancova": ancova_row,
        "checked": len(cells),
        "skipped": len(skipped),
        "failed": len(failed) + (1 if ancova_row["status"] == "FAIL" else 0),
        "ok": not failed and ancova_row["status"] != "FAIL" and bool(cells),
    }


def missing_surrogates(run_cfg: dict) -> list:
    """Backbones whose configured checkpoint path does not exist — these
    will run RANDOM (the agent warns loudly; their rates are
    meaningless, so their baseline cells are skipped)."""
    keys = {
        "rn50": "clip_model_rn50",
        "rn101": "clip_model_rn101",
        "vit_b16": "clip_model_vit_b16",
        "vit_b32": "clip_model_vit_b32",
        "vit_l14": "clip_model_vit_l14",
    }
    out = []
    for name in run_cfg.get("attack_backbones", []):
        path = run_cfg.get(keys.get(name, ""), run_cfg.get("clip_model"))
        if not path or not os.path.exists(str(path)):
            out.append(name)
    return out


def _synthetic_config(tmp_dir: str):
    """Tiny random-weight attack config over a synthetic 2-image VQAv2
    subset — exercises the exact command path (config -> agent -> summary
    -> comparison) with no checkpoints (the JAX runbook's, unchanged)."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(tmp_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    questions, annotations = [], []
    for i in range(2):
        image_id = 9000 + i
        arr = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(
            os.path.join(img_dir, f"COCO_val2014_{image_id:012d}.jpg")
        )
        questions.append(
            {"question_id": i + 1, "image_id": image_id,
             "question": f"what is {i}?"}
        )
        annotations.append(
            {
                "question_id": i + 1, "image_id": image_id,
                "question_type": "what is", "answer_type": "other",
                "answers": [
                    {"answer": "cat", "answer_confidence": "yes",
                     "answer_id": 1}
                ],
            }
        )
    qpath = os.path.join(tmp_dir, "q.json")
    apath = os.path.join(tmp_dir, "a.json")
    with open(qpath, "w") as f:
        json.dump({"questions": questions}, f)
    with open(apath, "w") as f:
        json.dump({"annotations": annotations}, f)
    return {
        "model": {"arch": "minigpt4", "model_size": "tiny"},
        "datasets": {
            "evalvqav2": {
                "vis_processor": {
                    "val": {"name": "blip2_image_val", "image_size": 28}
                },
                "build_info": {
                    "images": {"storage": img_dir},
                    "questions": {"val": [qpath]},
                    "annotations": {"val": [apath]},
                },
            }
        },
        "run": {
            "agent": "image_text_attack",
            "attack_backbones": ["vit_tiny", "rn_tiny"],
            "attack_steps": 2,
            "attack_epsilon": 0.03,
            "sigma_grid": [0.0, 0.5],
            "rgf_queries": 0,
            "max_images": 2,
            "max_new_tokens": 3,
            "seq_len": 48,
            "output_dir": os.path.join(tmp_dir, "out_attack"),
        },
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--config-path",
        default=os.path.join(
            REPO, "configs", "attack_configs", "vqav2_attack.yaml"
        ),
    )
    parser.add_argument("--images", type=int, default=None)
    parser.add_argument("--rgf-queries", type=int, default=None)
    parser.add_argument("--tol", type=float, default=0.05)
    parser.add_argument(
        "--summary", default=None,
        help="compare an EXISTING attack_summary.json (skip the run)",
    )
    parser.add_argument(
        "--synthetic", action="store_true",
        help="tiny random-weight dry run of the whole command path",
    )
    parser.add_argument("--report", default="verify_attack_torch_report.json")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device the agent runs on (default: cuda)")
    args = parser.parse_args(argv)

    if args.summary:
        with open(args.summary) as handle:
            summary = json.load(handle)
        report = compare_summary(summary, tol=args.tol)
    else:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit(
                "verify_attack_torch: --device cuda, but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass --device cpu to run on the CPU"
            )
        setup_logger()
        if args.synthetic:
            import tempfile

            tmp_dir = tempfile.mkdtemp(prefix="verify_attack_torch_")
            data = _synthetic_config(tmp_dir)
        else:
            data = Config(args.config_path).to_dict()
        # the overrides go into the dict the config is built from:
        # ``Config.run`` hands out a copy, so an item set on it would
        # reach no agent
        run = data["run"]
        if args.images is not None:
            run["max_images"] = args.images
        if args.rgf_queries is not None:
            run["rgf_queries"] = args.rgf_queries
        config = Config(data)
        random_bb = missing_surrogates(run)
        if random_bb and not args.synthetic:
            print(
                f"verify_attack_torch: no surrogate checkpoint for {random_bb} — "
                "these backbones run RANDOM and their cells are skipped",
                file=sys.stderr,
            )
        agent = setup_agent(config, device=args.device)
        summary = agent.run()
        if args.synthetic:
            # no baseline claim at random weights: the dry run passes
            # when the command path produced a complete grid + ANCOVA
            grid = summary.get("success_rate_grid") or {}
            report = {
                "synthetic": True,
                "ok": bool(grid)
                and all(
                    rate is not None
                    for row in grid.values() for rate in row.values()
                )
                and "ancova" in summary,
                "grid": grid,
            }
        else:
            report = compare_summary(
                summary, tol=args.tol, random_backbones=random_bb
            )

    with open(args.report, "w") as handle:
        json.dump(report, handle, indent=2)
    print(json.dumps(report, indent=2))
    if not report["ok"]:
        status = "failed" if report.get("failed") else "undischarged"
        print(f"verify_attack_torch: {status}", file=sys.stderr)
    else:
        print("verify_attack_torch: all checked cells within tolerance")
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
