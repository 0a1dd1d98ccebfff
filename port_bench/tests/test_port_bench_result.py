"""The result line's shape, and the runs that must print none."""
import json
import os
import shutil
import subprocess
import sys

from port_bench import bench
from port_bench.tests.helpers import run_small


def test_port_bench_last_line_shape(root):
    result = run_small(root, "tomo-tem-256.stream", seed=2**31 + 7)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name in ("setup_s", "slices_per_s"):
        m = result["metrics"][name]
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_port_bench_trace_line_reports_the_per_layer_metrics(root):
    spec = bench.load_spec(root)
    per_layer = {m["name"] for m in bench.cell_metrics(
        spec, "tomo-tem-256.stream", True)}
    end_to_end = {m["name"] for m in bench.cell_metrics(
        spec, "tomo-tem-256.stream", False)}
    assert "setup_s" in end_to_end and "slices_per_s" in end_to_end
    assert "art_roofline.tomo" in per_layer and "setup_s" not in per_layer


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "tomo-tem-256.stream", "--seed", "1", "--seconds", "1", "--trace",
         "0", *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_port_bench_without_the_program_prints_no_result(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_port_bench_without_a_card_prints_no_result(root):
    proc = _run(root)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
