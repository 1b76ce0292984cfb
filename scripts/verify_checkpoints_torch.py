#!/usr/bin/env python
"""Quality runbook of the PyTorch port: the eval and certify subset stages
of ``scripts/verify_checkpoints.py``, run through the port's launcher
(``python -m certifiedgpt_tpu_torch.launch``), with their rows set beside
the reference numbers of ``BASELINE.md:9-26``.

  stage "eval"     the eval YAML (sigma 0 by default) on its first
                   ``--eval-questions`` questions
  stage "certify"  the certify YAML on its first ``--certify-images`` images

The model blocks of the shipped YAMLs read the real checkpoints from
``VICUNA_7B``, ``EVA_VIT_G``, ``QFORMER_CKPT`` and ``MINIGPT4_STAGE2`` (and
``VQA_FINETUNED``); a path that does not exist keeps a random init, so
this script's numbers mean something only once those files are present.
Usage::

    python scripts/verify_checkpoints_torch.py --run-eval --run-certify \\
        [--device cuda] --report verify_torch_report.json

Each stage runs on ``--device`` (the card by default). A stage that fails
is reported with its error and the others still run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# BASELINE.md:9-26 reference rows the quality runs compare against
BASELINE_EVAL = {
    "0.0": {"overall": 32.39, "yes/no": 48.17, "number": 23.44, "other": 21.70},
    "0.25": {"overall": 27.84},
    "0.5": {"overall": 29.04},
    "1.0": {"overall": 29.86},
}
BASELINE_CERTIFIED = {
    # radius -> (certified acc %, best sigma, std acc %)
    "0.5": (35.0, 1.0, 38.0),
    "1.0": (33.0, 1.0, 38.0),
    "2.0": (25.0, 0.25, 41.0),
    "3.0": (25.0, 0.25, 41.0),
}


def trim_vqa_jsons(data: dict, max_questions: int, workdir: str) -> None:
    """Point the ``datasets`` block of a config dict at copies of its
    question/annotation JSONs trimmed to the first ``max_questions``
    questions (the eval agent scores whole files; the runbook wants a
    bounded run)."""
    os.makedirs(workdir, exist_ok=True)
    for name, block in data["datasets"].items():
        build = block.get("build_info", {})
        questions = build.get("questions", {})
        annotations = build.get("annotations", {})
        for split, paths in list(questions.items()):
            with open(paths[0]) as handle:
                q = json.load(handle)
            q["questions"] = q["questions"][:max_questions]
            keep = {item["question_id"] for item in q["questions"]}
            q_path = os.path.join(workdir, f"{name}_{split}_q.json")
            with open(q_path, "w") as handle:
                json.dump(q, handle)
            questions[split] = [q_path]
            if split in annotations:
                with open(annotations[split][0]) as handle:
                    a = json.load(handle)
                a["annotations"] = [ann for ann in a["annotations"]
                                    if ann["question_id"] in keep]
                a_path = os.path.join(workdir, f"{name}_{split}_a.json")
                with open(a_path, "w") as handle:
                    json.dump(a, handle)
                annotations[split] = [a_path]


def _launch(mode: str, data: dict, path: str, device: str):
    from certifiedgpt_tpu_torch import launch

    with open(path, "w") as handle:
        json.dump(data, handle)  # JSON is YAML
    return launch.main([mode, "--config-path", path, "--device", device])


def run_eval_subset(config_path: str, max_questions: int, output_dir: str,
                    device: str = "cuda") -> dict:
    from certifiedgpt_tpu_torch.common.config import Config

    data = Config(config_path).to_dict()
    trim_vqa_jsons(data, max_questions, os.path.join(output_dir, "eval_subset"))
    data["run"]["output_dir"] = os.path.join(output_dir, "eval")
    results = _launch("eval", data, os.path.join(output_dir, "eval_config.yaml"), device)
    sigma = str(float(data["run"].get("noise_level", 0.0)))
    row = {
        "stage": "eval", "sigma": sigma,
        "overall_accuracy": results["overall_accuracy"],
        "per_answer_type": results["per_answer_type"],
        "num_questions": results["num_questions"],
        "baseline": BASELINE_EVAL.get(sigma),
    }
    base = BASELINE_EVAL.get(sigma)
    if base:
        row["delta_vs_baseline"] = results["overall_accuracy"] - base["overall"]
    return row


def run_certify_subset(config_path: str, max_images: int, output_dir: str,
                       device: str = "cuda") -> dict:
    from certifiedgpt_tpu_torch.common.config import Config

    data = Config(config_path).to_dict()
    data["run"]["max_images"] = max_images
    data["run"]["output_dir"] = os.path.join(output_dir, "certify")
    summary = _launch("certify", data, os.path.join(output_dir, "certify_config.yaml"),
                      device)
    return {
        "stage": "certify",
        "sigma": summary.get("sigma"),
        "n": summary.get("n"),
        "certified_accuracy_at_radius": summary.get("certified_accuracy_at_radius"),
        "abstention_rate": summary.get("abstention_rate"),
        "standard_accuracy": summary.get("standard_accuracy"),
        "mean_seconds_per_image": summary.get("mean_seconds_per_image"),
        "baseline_certified_at_radius": {
            r: {"certified_acc_pct": v[0], "at_sigma": v[1], "std_acc_pct": v[2]}
            for r, v in BASELINE_CERTIFIED.items()
        },
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run-eval", action="store_true")
    parser.add_argument("--run-certify", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--eval-config", default=os.path.join(
        REPO, "configs", "eval_configs", "vqav2_eval_noise_0.yaml"))
    parser.add_argument("--certify-config", default=os.path.join(
        REPO, "configs", "certify_configs", "vqav2_certify_noise_0.5.yaml"))
    parser.add_argument("--eval-questions", type=int, default=200)
    parser.add_argument("--certify-images", type=int, default=10)
    parser.add_argument("--output-dir", default="output/verify_checkpoints_torch")
    parser.add_argument("--report", default=None)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    report = {"stages": [], "device": args.device}

    def run_stage(name, fn, *fn_args):
        # a failed stage is recorded with its error; the others still run
        print(f"[RUN ] {name}")
        try:
            row = fn(*fn_args)
        except Exception as exc:
            row = {"stage": name, "error": repr(exc)}
        report["stages"].append(row)
        print(f"       -> {json.dumps(row)}")

    if args.run_eval:
        run_stage(f"eval subset ({args.eval_questions} questions)", run_eval_subset,
                  args.eval_config, args.eval_questions, args.output_dir, args.device)
    if args.run_certify:
        run_stage(f"certify subset ({args.certify_images} images)", run_certify_subset,
                  args.certify_config, args.certify_images, args.output_dir, args.device)
    print("\n=== port quality report ===")
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as handle:
            json.dump(report, handle, indent=2)
        print(f"report written to {args.report}")
    return report


if __name__ == "__main__":
    main()
