"""``BENCHMARK.json`` keeps to the shape its checker reads: names, units,
bounds, the cells' files, the metrics' cells, and a full check's time."""
import json
import re

from port_bench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_port_bench_spec_names_units_and_keys(root):
    spec = bench.load_spec(root)
    assert set(spec) == KEYS
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for entry in spec["configs"] + spec["workloads"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)), group


def test_port_bench_spec_files_and_cells(root):
    spec = bench.load_spec(root)
    assert spec["paths"] == ["port_bench"]
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"].startswith("port_bench/")
        json.loads((root / c["file"]).read_text())
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        bench.cell_files(root, w["name"])       # every file found


def test_port_bench_spec_bounds_and_metrics_per_cell(root):
    spec = bench.load_spec(root)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in spec["workloads"]:
        reported = {m["name"] for m in bench.cell_metrics(spec, w["name"],
                                                         False)}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert bench.cell_metrics(spec, w["name"], True), w["name"]
    for m in spec["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in bench.cell_metrics(
                spec, w, False)}, (m["name"], w)


def test_port_bench_run_seconds_fit_a_full_check_of_24_cells(root):
    rs = bench.load_spec(root)["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
