"""The port's dry-run (``repro_torch.launch.dryrun``, ``training.lower_cell``,
``parallel/dp.lower_dp_cell``) against ``repro/launch/dryrun.py``:

* ``model_param_counts`` equal to the reference's for all ten archs' full
  configs, and for the MoE archs with the all-to-all overrides (padded
  experts count in the total, not in the active compute);
* ``model_flops`` equal to the reference's (rtol 1e-12) for every arch ×
  its applicable shapes;
* ``run_cell`` on the host (``device="cpu"``) on a (2, 2, 2) fake mesh
  for reduced internlm2-1.8b and granite-moe-3b-a800m at the smoke train
  shape, the counterpart of tests/test_multidevice.py:178: ok, flops and
  peak above 0, the record's keys;
* a (1, 1) cell's trace on fake tensors equal to a real CPU run of the
  same ``lower_cell`` under the walker, flops and bytes exactly;
* a sharded prefill holding only its rank's block of the cache (the
  production prefill_32k cell's trace found each rank making the whole
  cache);
* ``lower_dp_cell`` at world 8: the collective bytes exactly those of its
  reduce-scatter of the padded fp32 flat vector, its bf16 all-gather and
  its scalar all-reduces, from ``flatten_params``;
* a refusal when a process group exists, and a 'cuda' cell on a torch
  without CUDA recorded as failed, never traced on the host.
"""
import json
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import (REFERENCE_ARCHS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import (fake_group, model_flops,
                                       model_param_counts, run_cell,
                                       trace_cell)
from repro_torch.training import lower_cell
from tests.test_multidevice import run_with_devices

# overrides that send the MoE archs down the all-to-all path, padding
# granite's 40 experts to 48 and kimi-k2's 384 to 512
A2A = {"granite-moe-3b-a800m": {"_moe_impl": "a2a", "_moe_pad_experts": 16},
       "kimi-k2-1t-a32b": {"_moe_impl": "a2a", "_moe_pad_experts": 256}}
SMOKE = ShapeConfig("smoke_train", 64, 8, "train")
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "tag", "ok", "trace_s",
               "memory", "cost", "breakdown", "roofline"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "nvlink_s", "network_s",
                 "dominant", "model_flops", "model_flops_per_chip",
                 "useful_ratio", "params_total", "params_active"}


@pytest.fixture(scope="module")
def reference():
    """The reference's parameter counts (also with the a2a overrides) and
    model FLOPs of every arch and applicable shape."""
    body = f"""
        import json
        from repro.configs import SHAPES, all_archs, applicable_shapes, \\
            get_config
        from repro.launch.dryrun import model_flops, model_param_counts
        out = {{"params": {{}}, "a2a": {{}}, "flops": {{}}}}
        for arch in all_archs():
            cfg = get_config(arch)
            out["params"][arch] = model_param_counts(cfg)
            for sh in applicable_shapes(cfg):
                out["flops"][arch + "|" + sh] = model_flops(cfg, SHAPES[sh])
        for arch, ov in {A2A!r}.items():
            cfg = get_config(arch).replace(sharding_overrides=ov)
            out["a2a"][arch] = model_param_counts(cfg)
        print("JSON", json.dumps(out))
    """
    out = run_with_devices(textwrap.dedent(body), n=8)
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][0]
    return json.loads(line[5:])


def test_torch_dryrun_covers_the_reference_archs(reference):
    assert sorted(REFERENCE_ARCHS) == sorted(reference["params"])


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_torch_model_param_counts_equal_the_reference(reference, arch):
    assert list(model_param_counts(get_config(arch))) == \
        reference["params"][arch]


@pytest.mark.parametrize("arch", sorted(A2A))
def test_torch_model_param_counts_with_padded_experts(reference, arch):
    cfg = get_config(arch).replace(sharding_overrides=A2A[arch])
    total, active = model_param_counts(cfg)
    assert [total, active] == reference["a2a"][arch]
    assert total > model_param_counts(get_config(arch))[0]
    assert active == model_param_counts(get_config(arch))[1]


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a in REFERENCE_ARCHS
                                  for s in applicable_shapes(get_config(a))])
def test_torch_model_flops_equal_the_reference(reference, cell):
    arch, sh = cell.split("|")
    got = model_flops(get_config(arch), SHAPES[sh])
    assert got == pytest.approx(reference["flops"][cell], rel=1e-12)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m"])
def test_torch_run_cell_on_a_small_multi_pod_mesh(tmp_path, arch):
    rec = run_cell(arch, SMOKE, True, str(tmp_path), device="cpu",
                   config=get_config(arch, reduced=True),
                   mesh_shape=((2, 2, 2), ("pod", "data", "model")))
    assert rec["ok"], rec.get("error")
    assert set(rec) == RECORD_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert (rec["mesh"], rec["chips"]) == ("2x2x2", 8)
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["peak_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    # a sharded step on 8 ranks moves bytes between them, all inside a node
    assert rec["cost"]["nvlink_bytes"] > 0
    assert rec["cost"]["network_bytes"] == 0
    scopes = {r["scope"] for r in rec["breakdown"]}
    assert {"layer0/attention", "optimizer", "ce0/backward"} <= scopes
    written = json.loads((tmp_path / f"{arch}__smoke_train.json").read_text())
    assert written == json.loads(json.dumps(rec))
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m"])
def test_torch_fake_trace_equals_a_real_run(arch, kind):
    """The dry-run's program is the step: traced on fake tensors and run
    on real ones under the same walker, the counts are equal."""
    config = get_config(arch, reduced=True)
    with fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cell, got_kind = lower_cell(config, ShapeConfig("t", 64, 4, kind),
                                    mesh)
        fake = trace_cell(cell)
        real = trace_cell(cell, fake=False)
    assert got_kind == kind
    for key in ("flops", "bytes", "ops", "transcendentals"):
        assert fake["cost"][key] == real["cost"][key], key
    assert fake["cost"]["flops"] > 0
    assert fake["memory"] == real["memory"]


def test_torch_run_cell_saves_the_walker_rows(tmp_path):
    """``--save-trace``: one gzipped JSON row an operation, whose products
    and bytes sum to the record's cost."""
    import gzip

    rec = run_cell("internlm2-1.8b", ShapeConfig("p", 64, 2, "prefill"),
                   False, str(tmp_path), device="cpu", save_trace=True,
                   config=get_config("internlm2-1.8b", reduced=True),
                   mesh_shape=((1, 1), ("data", "model")), tag="_rows")
    assert rec["ok"], rec.get("error")
    with gzip.open(tmp_path / "internlm2-1.8b__p_rows.trace.jsonl.gz",
                   "rt") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == rec["cost"]["ops"]
    assert sum(r["flops"] for r in rows) == rec["cost"]["flops"]
    assert sum(r["bytes"] for r in rows) == rec["cost"]["bytes"]
    assert (tmp_path / "internlm2-1.8b__p_rows.json").exists()


def test_torch_sharded_prefill_holds_only_its_block_of_the_cache():
    """On (data 2, model 2) a rank's prefill makes only its own block of
    the cache (a quarter: the rows over 'data', the KV heads over
    'model'), as the reference's sharded zeros are; a cache made whole
    and then placed would hold the global one on every rank."""
    config = get_config("internlm2-1.8b", reduced=True)
    B, S = 8, 2048
    whole_cache = (2 * config.num_layers * B * S * config.num_kv_heads
                   * config.resolved_head_dim
                   * config.activation_dtype.itemsize)
    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cell, _ = lower_cell(config, ShapeConfig("p", S, B, "prefill"),
                             mesh)
        memory = trace_cell(cell)["memory"]
    logits = B * config.vocab_size * config.activation_dtype.itemsize
    assert memory["output_bytes"] <= whole_cache // 4 + logits
    assert memory["output_bytes"] >= whole_cache // 4


def test_torch_lower_dp_cell_collectives():
    """At world 8 a rank's wire bytes are its reduce-scatter of the padded
    fp32 flat vector, its bf16 all-gather of the updated shards and the
    all-reduces of the gradient norm and the metrics, by the reference's
    formulas."""
    from repro_torch.models.registry import param_shapes
    from repro_torch.parallel.dp import flatten_params, lower_dp_cell

    world = 8
    config = get_config("internlm2-1.8b", reduced=True)
    shape = ShapeConfig("smoke_train", 32, 8, "train")
    with fake_group(world):
        mesh = init_device_mesh("cpu", (world,))
        cell = lower_dp_cell(config, shape, mesh, opt=OptimizerConfig())
        traced = trace_cell(cell)
    with torch.device("meta"):
        flat, _ = flatten_params(param_shapes(config), world)
    n_pad = flat.numel()
    frac = (world - 1) / world
    metrics = 5              # loss, aux_loss, lr, grad_norm, total_loss
    want = {"reduce_scatter": n_pad * 4 * frac,
            "all_gather": n_pad * 2 * frac,
            "all_reduce": 2 * 4 * frac + 2 * 4 * metrics * frac}
    assert traced["cost"]["collectives"] == pytest.approx(want, abs=1e-6)
    assert traced["cost"]["nvlink_bytes"] == pytest.approx(
        sum(want.values()))
    assert traced["cost"]["network_bytes"] == 0


def test_torch_run_cell_refuses_an_existing_group(tmp_path):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already has a process group"):
            run_cell("internlm2-1.8b", SMOKE, False, str(tmp_path),
                     device="cpu", config=get_config("internlm2-1.8b",
                                                     reduced=True),
                     mesh_shape=((2,), ("data",)))
    finally:
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a torch without CUDA is what this checks")
def test_torch_cuda_cell_fails_without_cuda(tmp_path):
    """A 'cuda' cell on a torch without CUDA fails at the mesh and is
    recorded so: nothing carries on with host tensors."""
    rec = run_cell("internlm2-1.8b", SMOKE, False, str(tmp_path),
                   device="cuda", config=get_config("internlm2-1.8b",
                                                    reduced=True),
                   mesh_shape=((2, 2), ("data", "model")))
    assert not rec["ok"]
    assert "cuda" in rec["error"].lower()
    assert "cost" not in rec
    assert not dist.is_initialized()


def test_torch_dryrun_main_needs_a_cell():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "internlm2-1.8b"])
