"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and new entries, and edits no file the
benchmark has: the harness finds each by its name."""
import hashlib
import json
import shutil
import time

from port_bench import bench


def digests(root):
    files = [root / "BENCHMARK.json", *sorted(
        p for p in (root / "port_bench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)]
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files}


def test_port_bench_new_config_cell_and_metric_are_new_files(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    b = tmp_path / "port_bench"
    config = json.loads((b / "configs" / "tomo-tem-256.json").read_text())
    config.update(name="tomo-tem-16", nray=16, angles=9, nslice=16,
                  batch_slices=8, partitions=2, executors=2,
                  reduced=["nray", "nslice"])
    (b / "configs" / "tomo-tem-16.json").write_text(json.dumps(config))
    (b / "traffic" / "stream_deep.json").write_text(json.dumps(
        {"driver": "tomo_stream", "loop": "closed", "queued_batches": 4,
         "warmup_batches": 1}))
    (b / "workloads" / "tomo-tem-16.stream_deep.json").write_text(
        json.dumps({"trace_batches": 2, "limits": {"volume_err": 1e-4}}))
    (b / "metrics" / "batches.tomo16.py").write_text(
        "def read(rec):\n"
        "    spans = rec.get('spans')\n"
        "    return float(len(spans)) if spans else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tomo-tem-16", "source": "x",
                            "file": "port_bench/configs/tomo-tem-16.json",
                            "reduced": ["nray", "nslice"], "why": "test"})
    spec["workloads"].append({"name": "tomo-tem-16.stream_deep",
                              "config": "tomo-tem-16",
                              "traffic": "stream_deep", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "batches.tomo16", "unit": "batches",
                              "better": "higher", "source": "program_span",
                              "layer": "Spark layer",
                              "moves": "slices_per_s",
                              "workloads": ["tomo-tem-16.stream_deep"]})
    for m in spec["end_to_end"]:
        if m["name"] == "slices_per_s":
            m["workloads"].append("tomo-tem-16.stream_deep")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digests(tmp_path)
    edited = [p for p, h in before.items() if after[p] != h]
    assert edited == [tmp_path.joinpath("BENCHMARK.json").relative_to(
        tmp_path)]

    traced = bench.run_cell(tmp_path, "tomo-tem-16.stream_deep", 3, 0.3,
                            True, "cpu", time.perf_counter())
    assert traced["correct"] is True
    assert traced["metrics"]["batches.tomo16"]["value"] >= 1
    assert traced["metrics"]["batches.tomo16"]["unit"] == "batches"
    timed = bench.run_cell(tmp_path, "tomo-tem-16.stream_deep", 3, 0.3,
                           False, "cpu", time.perf_counter())
    assert set(timed["metrics"]) == {"setup_s", "slices_per_s"}
