"""Plumbing of the port's quality runbook (``scripts/verify_checkpoints_torch.py``)
on the CPU: its eval and certify subset stages run the port's launcher on a
tiny written VQAv2 set and report rows beside ``BASELINE.md``'s; the
numbers themselves need the real checkpoints."""

import importlib.util
import json
import os

from test_torch_launch import vqa  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "verify_checkpoints_torch", os.path.join(REPO, "scripts", "verify_checkpoints_torch.py"))
vct = importlib.util.module_from_spec(spec)
spec.loader.exec_module(vct)


def test_trim_vqa_jsons(vqa, tmp_path):  # noqa: F811
    data = vqa("image_text_eval", "trim")
    vct.trim_vqa_jsons(data, 2, str(tmp_path))
    build = data["datasets"]["evalvqav2"]["build_info"]
    q = json.load(open(build["questions"]["val"][0]))
    a = json.load(open(build["annotations"]["val"][0]))
    assert [x["question_id"] for x in q["questions"]] == [1, 2]
    assert [x["question_id"] for x in a["annotations"]] == [1, 2]


def test_runbook_stages_through_the_launcher(vqa, tmp_path):  # noqa: F811
    eval_cfg = tmp_path / "eval.yaml"
    eval_cfg.write_text(json.dumps(vqa("image_text_eval", "rb-eval", batch_size=2)))
    cert_cfg = tmp_path / "certify.yaml"
    cert_cfg.write_text(json.dumps(vqa("image_text_certify", "rb-cert")))
    report_path = tmp_path / "report.json"
    report = vct.main(["--run-eval", "--run-certify", "--device", "cpu",
                       "--eval-config", str(eval_cfg), "--certify-config", str(cert_cfg),
                       "--eval-questions", "3", "--certify-images", "1",
                       "--output-dir", str(tmp_path / "out"), "--report", str(report_path)])
    eval_row, cert_row = report["stages"]
    assert "error" not in eval_row and "error" not in cert_row, report
    assert eval_row["num_questions"] == 3 and eval_row["sigma"] == "0.0"
    assert eval_row["delta_vs_baseline"] == eval_row["overall_accuracy"] - 32.39
    assert set(cert_row["certified_accuracy_at_radius"]) == {"0.5", "1.0", "2.0", "3.0"}
    assert cert_row["baseline_certified_at_radius"]["0.5"]["certified_acc_pct"] == 35.0
    assert json.load(open(report_path)) == report
    assert (tmp_path / "out" / "eval" / "eval_results.json").exists()
    assert len(open(tmp_path / "out" / "certify" / "certify_results.jsonl").readlines()) == 1
