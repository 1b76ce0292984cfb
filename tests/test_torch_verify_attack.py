"""Plumbing of the port's attack runbook (``scripts/verify_attack_torch.py``),
the twin of ``tests/test_verify_attack.py``: the BASELINE.md comparison on
synthetic summaries, equal to the JAX runbook's (``scripts/verify_attack.py``)
case by case, and the ``--synthetic --device cpu`` dry run through the
port's attack agent (config -> agent -> summary -> report)."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


va = _load("verify_attack")
vat = _load("verify_attack_torch")


def _summary(grid, ancova_coef=-0.01, ancova_p=1e-4):
    return {
        "sigma_grid": [0.0, 0.25, 0.5, 1.0],
        "success_rate_grid": grid,
        "ancova": {
            "coefficients": {
                "sigma": {"estimate": -0.002, "p_value": 0.2},
                "sigma:backbone[rn101]": {
                    "estimate": ancova_coef, "p_value": ancova_p,
                },
            }
        },
    }


def _baseline_grid(shift=0.0):
    return {name: {sig: rate + shift for sig, rate in row.items()}
            for name, row in vat.BASELINE_ASR.items()}


def _int_sigma_keys(grid):
    # a config written `sigma_grid: [0, 1]` keys its cells '0'/'1'
    return {name: {("0" if s == "0.0" else "1" if s == "1.0" else s): r
                   for s, r in row.items()} for name, row in grid.items()}


def _out_of_tolerance():
    grid = _baseline_grid()
    grid["vit_l14"]["0.5"] = 0.80  # far from the published 0.449
    return grid


# name -> (summary, random backbones, expected report fields)
CASES = {
    "within_tolerance": (
        _summary(_baseline_grid(0.02)), (),
        {"ok": True, "checked": 20, "skipped": 0, "failed": 0, "ancova": "ok"}),
    # the comparison normalizes both sides instead of silently skipping
    # those columns
    "sigma_keys_0_1": (
        _summary(_int_sigma_keys(_baseline_grid(0.02))), (),
        {"ok": True, "checked": 20, "skipped": 0, "failed": 0, "ancova": "ok"}),
    "out_of_tolerance": (
        _summary(_out_of_tolerance()), (),
        {"ok": False, "checked": 20, "skipped": 0, "failed": 1, "ancova": "ok",
         "FAIL": [("vit_l14", "0.5")]}),
    # every cell skipped (rn50 ran random, the rest absent): the clause is
    # undischarged, not failed
    "random_and_missing": (
        _summary({"rn50": dict(vat.BASELINE_ASR["rn50"])}), ("rn50",),
        {"ok": False, "checked": 0, "skipped": 20, "failed": 0, "ancova": "ok"}),
    "ancova_wrong_sign": (
        _summary(_baseline_grid(), ancova_coef=0.01), (),
        {"ok": False, "checked": 20, "skipped": 0, "failed": 1, "ancova": "FAIL"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_summary(case):
    summary, random_bb, want = CASES[case]
    report = vat.compare_summary(summary, tol=0.05, random_backbones=random_bb)
    assert {k: report[k] for k in ("ok", "checked", "skipped", "failed")} == \
        {k: want[k] for k in ("ok", "checked", "skipped", "failed")}, report
    assert report["ancova"]["status"] == want["ancova"]
    assert [(c["backbone"], c["sigma"]) for c in report["cells"]
            if c["status"] == "FAIL"] == want.get("FAIL", [])


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_summary_equals_the_jax_runbooks(case):
    summary, random_bb, _ = CASES[case]
    assert vat.compare_summary(summary, tol=0.05, random_backbones=random_bb) == \
        va.compare_summary(summary, tol=0.05, random_backbones=random_bb)


def test_ancova_of_surrogates_all_random_is_skipped():
    """An all-random run's ANCOVA (the grid's similarities all 0: estimate
    0, p 1) is skipped with its cells; the JAX runbook counts it failed."""
    grid = {name: {s: 0.0 for s in row} for name, row in vat.BASELINE_ASR.items()}
    summary = {"sigma_grid": [0.0, 0.25, 0.5, 1.0], "success_rate_grid": grid,
               "success_rate_per_backbone": {name: 0.0 for name in grid},
               "ancova": {"coefficients": {
                   "sigma": {"estimate": 0.0, "p_value": 1.0},
                   **{f"sigma:backbone[{n}]": {"estimate": 0.0, "p_value": 1.0}
                      for n in sorted(grid)[1:]}}}}
    random_bb = list(vat.BASELINE_ASR)
    report = vat.compare_summary(summary, random_backbones=random_bb)
    assert (report["checked"], report["skipped"], report["failed"], report["ok"]) == \
        (0, 20, 0, False)
    assert report["ancova"]["status"] == "skipped"
    assert va.compare_summary(summary, random_backbones=random_bb)["failed"] == 1
    # one surrogate with weights: the ANCOVA is checked
    report = vat.compare_summary(summary, random_backbones=random_bb[1:])
    assert report["ancova"]["status"] == "FAIL"


def test_missing_surrogates_reports_unmounted_paths(tmp_path):
    real = tmp_path / "clip.pt"
    real.write_bytes(b"x")
    run = {
        "attack_backbones": ["rn50", "vit_b32", "rn101"],
        "clip_model_rn50": str(real),
        "clip_model_vit_b32": str(tmp_path / "nope.pt"),
        "clip_model": str(real),
    }
    assert vat.missing_surrogates(run) == ["vit_b32"]
    assert vat.missing_surrogates(run) == va.missing_surrogates(run)


def test_synthetic_dry_run_end_to_end(tmp_path, monkeypatch):
    """--synthetic drives config -> the port's agent -> summary -> report on
    tiny random weights; passes iff the grid is complete and ANCOVA
    present. ``--images`` reaches the agent."""
    monkeypatch.chdir(tmp_path)
    setup_agent, seen = vat.setup_agent, []

    def spy(config, device="cuda"):
        seen.append(setup_agent(config, device=device))
        return seen[-1]

    monkeypatch.setattr(vat, "setup_agent", spy)
    report = vat.main(["--synthetic", "--device", "cpu", "--images", "1",
                       "--report", str(tmp_path / "rep.json")])
    assert json.loads((tmp_path / "rep.json").read_text()) == report
    assert report["synthetic"] is True
    assert report["ok"], report
    assert set(report["grid"]) == {"vit_tiny", "rn_tiny"}
    (agent,) = seen
    assert agent.device == "cpu"
    # one image x two backbones x two sigmas
    with open(os.path.join(agent.output_dir, "attack_results.jsonl")) as handle:
        assert len(handle.readlines()) == 4


def test_summary_compare_mode(tmp_path):
    path = tmp_path / "attack_summary.json"
    path.write_text(json.dumps(_summary(_baseline_grid())))
    report = vat.main(["--summary", str(path), "--report", str(tmp_path / "rep.json")])
    assert json.loads((tmp_path / "rep.json").read_text()) == report
    assert report["ok"]
    assert report["checked"] == 20


@pytest.mark.parametrize("grid,rc,status", [
    (_baseline_grid(), 0, "all checked cells within tolerance"),
    (_out_of_tolerance(), 1, "verify_attack_torch: failed"),
    ({}, 1, "verify_attack_torch: undischarged"),  # no cell to check
])
def test_exit_codes(tmp_path, grid, rc, status):
    path = tmp_path / "attack_summary.json"
    path.write_text(json.dumps(_summary(grid)))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "verify_attack_torch.py"),
         "--summary", str(path), "--report", str(tmp_path / "rep.json")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == rc, proc.stderr
    assert status in (proc.stdout if rc == 0 else proc.stderr)


def test_device_cuda_without_cuda_names_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        vat.main(["--synthetic", "--report", str(tmp_path / "rep.json")])
