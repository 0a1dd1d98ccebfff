"""The port's elasticity on the CPU: the counterparts of
tests/test_elastic_ingest.py on the port's ``LagPolicy``, ``IngestRunner``
and ``StreamingContext``; the same scripted lag and shed feed through both
packages' policies (equal histories); the ``ElasticController`` over CPU
worker slots; the elastic recovery of tests/test_multidevice.py (8 workers
shrink to 5 at step 6, steps 4-5 re-run from the step-4 checkpoint) held to
the reference's run of the same script on 8 virtual devices (1e-5); and the
§III ``--elastic`` stream at ``--fast`` size, its batch errors held to the
JAX solver replayed on its batch boundaries.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.ptycho import sim as jsim
from repro.apps.ptycho import solver as jsolver
from repro.core import fault as jax_fault
from repro_torch.apps.ptycho.stream import (ELASTIC_WORKERS, parse_args,
                                            run_stream)
from repro_torch.checkpoint import restore, save
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.fault import (ElasticController, LagPolicy,
                                    run_with_recovery)
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.ingest import IngestConfig, IngestRunner
from repro_torch.data.sources import SyntheticRateSource

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_lock_order():
    """The port's counterpart of tests/conftest.py's harness: traced locks
    for the test, and no lock-order cycle at the end."""
    locktrace.enable()
    try:
        yield
    finally:
        report = locktrace.disable().report()
    assert not report.cycles, (
        "lock-order cycles detected (potential deadlock):\n"
        + report.describe())


def make_policy(cls=LagPolicy, **kw):
    kw.setdefault("sustain", 3)
    kw.setdefault("cooldown", 5.0)
    kw.setdefault("clock", lambda: 0.0)      # tests always pass now=
    return cls(100, 10, **kw)


class StubController:
    """Duck-typed ElasticController: records scale calls, no devices."""

    def __init__(self, world=4, max_workers=8):
        self.world = world
        self.max_workers = max_workers
        self.calls = []

    def add_workers(self, n):
        self.world = min(self.max_workers, self.world + n)
        self.calls.append(("add", n))

    def fail_workers(self, n):
        assert n < self.world, "policy must never fail every worker"
        self.world -= n
        self.calls.append(("fail", n))


# -- scripted decision tests --------------------------------------------------

def test_torch_scale_up_requires_sustained_lag():
    p = make_policy()
    assert [p.observe(150, now=t) for t in range(3)] == [0, 0, 1]


def test_torch_lag_blip_does_not_scale():
    p = make_policy()
    feed = [150, 150, 50, 150, 150]
    assert [p.observe(lag, now=t) for t, lag in enumerate(feed)] == [0] * 5


def test_torch_no_flapping_inside_hysteresis_band():
    p = make_policy()
    feed = [50, 90, 20, 60, 95, 15, 40, 80] * 3
    assert all(p.observe(lag, now=t) == 0 for t, lag in enumerate(feed))


def test_torch_cooldown_suppresses_consecutive_events():
    p = make_policy(cooldown=5.0)
    assert [p.observe(150, now=t) for t in range(3)] == [0, 0, 1]
    assert [p.observe(150, now=t) for t in (3.0, 4.0, 6.9)] == [0, 0, 0]
    assert [p.observe(150, now=t) for t in (7.0, 8.0, 9.0)] == [0, 0, 1]


def test_torch_scale_down_on_drain():
    p = make_policy()
    assert [p.observe(0, now=t) for t in range(3)] == [0, 0, -1]


def test_torch_shed_records_count_as_overload_even_with_low_lag():
    p = make_policy()
    assert [p.observe(5, shed=64, now=t) for t in range(3)] == [0, 0, 1]


def test_torch_step_size_and_history():
    p = make_policy(step=3, sustain=1, cooldown=0.0)
    assert p.observe(500, now=0) == 3
    assert p.observe(0, now=1) == -3
    assert [(o.lag, o.delta) for o in p.history] == [(500, 3), (0, -3)]


def test_torch_band_validation():
    with pytest.raises(ValueError):
        LagPolicy(100, 100)
    with pytest.raises(ValueError):
        LagPolicy(100, 10, sustain=0)


# -- drive(): policy -> controller wiring -------------------------------------

def test_torch_drive_scales_controller_with_clamps():
    ctl = StubController(world=7, max_workers=8)
    p = make_policy(step=4, sustain=1, cooldown=0.0)
    assert p.drive(ctl, lag=500, now=0) == 1     # clamped to max_workers
    assert ctl.world == 8
    assert p.drive(ctl, lag=500, now=1) == 0     # already at max
    ctl2 = StubController(world=2)
    p2 = make_policy(step=4, sustain=1, cooldown=0.0)
    assert p2.drive(ctl2, lag=0, now=0) == -1    # never fails the last worker
    assert ctl2.world == 1
    assert p2.drive(ctl2, lag=0, now=1) == 0     # nothing left to shed


def test_torch_clamped_decision_does_not_burn_cooldown():
    ctl = StubController(world=8, max_workers=8)
    p = make_policy(sustain=2, cooldown=100.0)
    assert p.drive(ctl, lag=500, now=0) == 0
    assert p.drive(ctl, lag=500, now=1) == 0     # decided +1, clamped to 0
    ctl.world = 7                                # a worker freed up
    assert p.drive(ctl, lag=500, now=2) == 1     # immediate, no cooldown tax
    assert ctl.calls == [("add", 1)]


def test_torch_drive_reads_runner_lag_and_shed_deltas():
    broker = Broker()
    scripted = {"lag": 0}
    runner = IngestRunner(broker, lag_of=lambda topic: scripted["lag"])
    src = SyntheticRateSource(rate=1e9, total=1000)
    metrics = runner.add(src, IngestConfig(topic="t", policy="drop",
                                           max_pending=64))
    ctl = StubController(world=1)
    p = make_policy(sustain=2, cooldown=0.0)
    assert p.drive(ctl, runner, now=0) == 0
    assert p.drive(ctl, runner, now=1) == 0
    assert ctl.calls == []
    metrics.dropped += 32
    assert p.drive(ctl, runner, now=2) == 0      # shed delta seen, streak 1
    metrics.dropped += 32
    assert p.drive(ctl, runner, now=3) == 1      # sustained -> scale up
    assert ctl.calls == [("add", 1)]
    scripted["lag"] = 0
    assert p.drive(ctl, runner, now=4) == 0
    assert p.history[-1].shed == 0


def test_torch_slow_consumer_builds_lag_and_triggers_scale_event():
    """Real pipeline, deliberately slow consumer: the producer outruns the
    micro-batch loop, lag crosses the watermark for ``sustain`` consecutive
    batches, and the policy fires a scale-up on the controller."""
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=8)
    runner = IngestRunner(broker, consumer=sc)
    src = SyntheticRateSource(rate=1e9, total=400)
    runner.add(src, IngestConfig(topic="t", policy="block", max_pending=300,
                                 poll_batch=64))
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: len(rdd.collect()))
    ctl = StubController(world=1, max_workers=4)
    policy = LagPolicy(100, 10, sustain=3, cooldown=0.0)
    tick = 0
    while not (runner.done and sc.lag("t") == 0):
        runner.pump()
        sc.run_one_batch()
        policy.drive(ctl, runner, now=float(tick))
        tick += 1
        assert tick < 1000, "pipeline never drained"
    assert ("add", 1) in ctl.calls
    assert ctl.world > 1
    assert max(o.lag for o in policy.history) >= 100
    assert policy.history[-1].lag <= 10


# -- both packages' policies on one feed -------------------------------------

FEEDS = {
    "sustained": [(150, 0)] * 4 + [(0, 0)] * 6,
    "band_noise": [(50, 0), (90, 0), (20, 0), (150, 0), (150, 0), (60, 0),
                   (150, 0), (150, 0), (150, 0)],
    "shedding": [(5, 64), (5, 64), (5, 64), (5, 0), (0, 0), (0, 0), (0, 0)],
    "cooldown": [(150, 0)] * 12 + [(0, 0)] * 12,
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
@pytest.mark.parametrize("sustain,cooldown,step", [(3, 5.0, 1), (2, 0.0, 2),
                                                    (1, 2.5, 3)])
def test_torch_lag_policy_history_matches_reference(feed, sustain, cooldown,
                                                    step):
    """``observe`` and ``drive`` (against a clamping stub controller, at
    half-second ticks) through both packages' policies: equal deltas and
    histories."""
    kw = dict(sustain=sustain, cooldown=cooldown, step=step)
    ours, ref = make_policy(**kw), make_policy(jax_fault.LagPolicy, **kw)
    got = [ours.observe(lag, shed, now=0.5 * t)
           for t, (lag, shed) in enumerate(FEEDS[feed])]
    want = [ref.observe(lag, shed, now=0.5 * t)
            for t, (lag, shed) in enumerate(FEEDS[feed])]
    assert got == want
    c_ours, c_ref = StubController(2, 4), StubController(2, 4)
    ours, ref = make_policy(**kw), make_policy(jax_fault.LagPolicy, **kw)
    for t, (lag, _) in enumerate(FEEDS[feed]):
        assert (ours.drive(c_ours, lag=lag, now=0.5 * t)
                == ref.drive(c_ref, lag=lag, now=0.5 * t))
    assert c_ours.calls == c_ref.calls
    assert ([(o.now, o.lag, o.shed, o.delta) for o in ours.history]
            == [(o.now, o.lag, o.shed, o.delta) for o in ref.history])


# -- the controller -----------------------------------------------------------

def test_torch_elastic_controller_rebuilds_bridges_over_slots():
    ctl = ElasticController(num_workers=4, initial_workers=1,
                            devices=[CPU] * 6)
    assert (ctl.world, ctl.max_workers) == (1, 4)
    b1 = ctl.bridge()
    assert ctl.bridge() is b1 and b1.world == 1 and b1.group is None
    ctl.add_workers(2, step=3)
    b3 = ctl.bridge()
    assert b3 is not b1 and b3.world == 3 and b3.devices == (CPU,) * 3
    assert sorted(b3.pmi.kvs().snapshot()) == [f"coords/{r}"
                                               for r in range(3)]
    ctl.add_workers(5)                       # clamped to max_workers
    ctl.fail_workers(2, step=9)
    assert ctl.world == 2 and ctl.bridge().world == 2
    assert [(e.generation, e.world, e.reason, e.step) for e in ctl.events] \
        == [(1, 3, "grew to 3 workers", 3), (2, 4, "grew to 4 workers", -1),
            (3, 2, "failed 2 workers", 9)]
    with pytest.raises(ValueError):
        ctl.fail_workers(2)                  # never every worker
    with pytest.raises(ValueError):
        ElasticController(num_workers=3, devices=[CPU] * 2)
    with pytest.raises(ValueError):
        ElasticController(initial_workers=0, devices=[CPU] * 2)


def test_torch_elastic_controller_wants_a_card_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticController()


# -- elastic recovery against the reference -----------------------------------

_REFERENCE_RECOVERY = """
    import os, sys, json, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import save, restore
    from repro.core import ElasticController, run_with_recovery
    from repro.utils import shard_map_compat

    tmp = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    y = X @ rng.standard_normal((16,)).astype(np.float32)
    steps_run = []

    def step_fn(bridge, state, step):
        steps_run.append((step, bridge.world))
        w = state["w"]
        n = bridge.world
        rows = 64 // n

        def grad_prog(xb, yb):
            pred = xb[0] @ w
            g = xb[0].T @ (pred - yb[0]) / 64.0
            return jax.lax.psum(g, "workers")
        xs = np.stack(np.split(X[: rows * n], n))
        ys = np.stack(np.split(y[: rows * n], n))
        sharding = NamedSharding(bridge.mesh, P("workers"))
        prog = jax.jit(shard_map_compat(
            grad_prog, mesh=bridge.mesh, in_specs=(P("workers"),
                                                   P("workers")),
            out_specs=P()))
        g = prog(jax.device_put(xs, sharding), jax.device_put(ys, sharding))
        return {{"w": w - 0.1 * g}}

    def save_fn(state, step):
        save(tmp, step, {{"state": state}})

    def restore_fn(bridge):
        tree, step = restore(tmp, {{"state": {{"w": jnp.zeros((16,))}}}})
        return tree["state"], step

    ctl = ElasticController(num_workers=8)
    state, events = run_with_recovery(
        ctl, lambda b: {{"w": jnp.zeros((16,), jnp.float32)}}, step_fn,
        num_steps=12, save_fn=save_fn, restore_fn=restore_fn,
        checkpoint_every=4, failure_plan={{6: 3}})
    print(json.dumps({{"w": np.asarray(state["w"]).tolist(),
                      "steps": steps_run, "world": ctl.world}}))
"""


def test_torch_elastic_training_recovery_matches_reference(tmp_path):
    """Data-parallel least squares on 8 CPU worker slots, 3 workers killed
    before step 6, restored from the step-4 checkpoint onto 5 and run to
    step 12: the steps re-run, and the final weights equal the reference's
    run of the same script on 8 virtual devices within 1e-5."""
    code = textwrap.dedent(_REFERENCE_RECOVERY).format(
        src=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])

    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    y = X @ rng.standard_normal((16,)).astype(np.float32)
    ctx = Context()
    steps_run = []

    def step_fn(bridge, state, step):
        steps_run.append((step, bridge.world))
        w = state["w"]
        n = bridge.world
        rows = 64 // n
        blocks = list(zip(np.split(X[: rows * n], n),
                          np.split(y[: rows * n], n)))

        def grad(block):
            xb, yb = (torch.from_numpy(a) for a in block)
            return xb.T @ (xb @ w - yb) / 64.0

        g = bridge.allreduce(ctx.from_partitions(blocks).map_partitions(grad))
        return {"w": w - 0.1 * g}

    def save_fn(state, step):
        save(str(tmp_path), step, {"state": state})

    def restore_fn(bridge):
        tree, step = restore(str(tmp_path),
                             {"state": {"w": torch.zeros(16)}},
                             device=bridge.device)
        return tree["state"], step

    ctl = ElasticController(num_workers=8, devices=[CPU] * 8)
    state, events = run_with_recovery(
        ctl, lambda b: {"w": torch.zeros(16, dtype=torch.float32)}, step_fn,
        num_steps=12, save_fn=save_fn, restore_fn=restore_fn,
        checkpoint_every=4, failure_plan={6: 3})
    assert ctl.world == 5 and ref["world"] == 5
    assert len(events) == 1 and events[0].world == 5 and events[0].step == 6
    assert {w for _, w in steps_run} == {8, 5}
    assert [s for s, w in steps_run if w == 5][0] == 4
    assert [list(s) for s in steps_run] == ref["steps"]
    w = state["w"].numpy()
    np.testing.assert_allclose(w, np.asarray(ref["w"], np.float32),
                               rtol=1e-5, atol=1e-5)
    loss = float(np.mean((X @ w - y) ** 2))
    assert np.isfinite(loss) and loss < np.mean(y ** 2)


# -- the §III stream with --elastic -------------------------------------------

def test_torch_elastic_stream_fast(tmp_path):
    """``--elastic --fast`` on the CPU: every frame consumed through the
    threaded runner, one policy observation a batch, the world within
    [1, 4] and each scale event's bridge handed to the pipeline, the peak
    lag within the runner's bound, and the batch errors equal to the JAX
    solver replayed on the run's batch boundaries."""
    args = parse_args(["--fast", "--elastic", "--out", str(tmp_path)])
    res = run_stream(args, device="cpu")
    el = res["elastic"]
    assert res["report"].records == 81 and res["frames_seen"][-1] == 81
    assert el["observations"] == res["report"].batches == len(el["worlds"])
    assert all(1 <= w <= ELASTIC_WORKERS for w in el["worlds"])
    assert el["handed"] == [e.world for e in el["events"]]
    assert el["peak_lag"] <= el["max_pending"] + el["poll_batch"]
    assert el["shed"] == 0                     # the block policy sheds none
    assert res["quality"] > 0.9

    prob = jsim.simulate(args.obj_size, args.probe_size, args.scan_step)
    cfg = jsolver.SolverConfig(beta=0.75, use_pallas=False)
    step = jax.jit(lambda psi, mag, pos, probe, it: jsolver.raar_step(
        psi, mag, pos, probe, prob.object_true.shape, cfg, it))
    positions = jnp.asarray(prob.positions)
    probe, psi, n_seen, it, errs = prob.probe_true, None, 0, 0, []
    for n_new in res["frames_seen"]:
        fresh = jsolver.init_waves(prob.magnitudes[n_seen:n_new], probe)
        psi = fresh if psi is None else jnp.concatenate([psi, fresh])
        for _ in range(args.iters_per_batch):
            psi, _, probe, err = step(psi, prob.magnitudes[:n_new],
                                      positions[:n_new], probe, it)
            it += 1
        errs.append(float(err))
        n_seen = n_new
    np.testing.assert_allclose(res["batch_errors"], errs, rtol=0, atol=1e-3)
