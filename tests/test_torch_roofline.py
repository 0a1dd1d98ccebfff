"""The port's roofline table (``repro_torch.launch.roofline``) against
``repro/launch/roofline.py``, which imports no JAX: on the same records,
the port's table with its two collective columns, ``nvlink_s`` and
``net_s``, mapped back to the reference's ``ici_s`` and ``dcn_s`` equals
the reference's character for character; ``load`` keeps the ok records
of one tag; ``main`` groups the cells by their dominant term."""
import json

import pytest

from repro.launch import roofline as ref_roofline
from repro_torch.launch import roofline

RECORDS = [
    ("internlm2-1.8b", "train_4k", 0.412, 0.981, 0.0021, 0.733, "memory",
     4.56e18, 0.31, 41.2 * 2**30),
    ("gemma-7b", "prefill_32k", 1.873, 0.252, 0.0, 0.0, "compute",
     1.2e17, 0.98, 12.25 * 2**30),
    ("granite-moe-3b-a800m", "decode_32k", 0.0001, 0.004, 0.0123, 0.0512,
     "collective", 3.3e12, 0.07, 3.01 * 2**30),
    ("gemma-7b", "decode_32k", 0.0002, 0.0061, 0.0, 0.0, "memory",
     9.1e12, 0.5, 20.0 * 2**30),
]


def _records(tag=""):
    """(the port's records, the same as the reference's)."""
    ours, theirs = [], []
    for arch, shape, c, m, nv, net, dom, mf, useful, peak in RECORDS:
        base = {"arch": arch, "shape": shape, "tag": tag, "ok": True,
                "memory": {"peak_bytes": peak}}
        rf = {"compute_s": c, "memory_s": m, "dominant": dom,
              "model_flops": mf, "useful_ratio": useful}
        ours.append({**base, "roofline": {**rf, "nvlink_s": nv,
                                          "network_s": net}})
        theirs.append({**base, "roofline": {**rf, "collective_s": nv,
                                            "dcn_s": net}})
    return ours, theirs


@pytest.mark.parametrize("md", [True, False])
def test_torch_roofline_table_equals_the_reference(md):
    ours, theirs = _records()
    got = roofline.table(ours, md=md)
    mapped = got.replace("nvlink_s", "ici_s").replace("net_s", "dcn_s")
    assert mapped == ref_roofline.table(theirs, md=md)
    assert "nvlink_s" in got.splitlines()[0] and "net_s" in got


def test_torch_roofline_load_keeps_ok_records_of_the_tag(tmp_path):
    ours, _ = _records()
    mesh = tmp_path / "single"
    mesh.mkdir()
    for i, rec in enumerate(ours):
        (mesh / f"{rec['arch']}__{rec['shape']}.json").write_text(
            json.dumps(rec))
    failed = {**ours[0], "shape": "prefill_32k", "ok": False}
    (mesh / "internlm2-1.8b__prefill_32k.json").write_text(
        json.dumps(failed))
    tagged = {**ours[1], "tag": "_v2"}
    (mesh / "gemma-7b__prefill_32k_v2.json").write_text(json.dumps(tagged))
    rows = roofline.load("single", results=str(tmp_path))
    assert sorted((r["arch"], r["shape"]) for r in rows) == sorted(
        (r["arch"], r["shape"]) for r in ours)
    assert [r["tag"] for r in roofline.load("single", "_v2",
                                            results=str(tmp_path))] == ["_v2"]


def test_torch_roofline_main_groups_by_dominant_term(tmp_path, capsys):
    ours, _ = _records()
    (tmp_path / "single").mkdir()
    for rec in ours:
        (tmp_path / "single" / f"{rec['arch']}__{rec['shape']}.json"
         ).write_text(json.dumps(rec))
    roofline.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    groups = [ln for ln in out if ln.startswith("**")]
    assert groups == [
        "**collective-bound** (1): granite-moe-3b-a800m×decode_32k",
        "**compute-bound** (1): gemma-7b×prefill_32k",
        "**memory-bound** (2): gemma-7b×decode_32k, internlm2-1.8b×train_4k"]
    fixes = [ln for ln in out if ln.startswith("  -> ")]
    assert fixes == [f"  -> {roofline.BOTTLENECK_FIXES[d]}"
                     for d in ("collective", "compute", "memory")]
    assert set(roofline.BOTTLENECK_FIXES) == set(ref_roofline.BOTTLENECK_FIXES)
    # the port's own words: no TPU memory or kernel language
    assert not any(w in " ".join(roofline.BOTTLENECK_FIXES.values())
                   for w in ("Pallas", "VMEM"))
