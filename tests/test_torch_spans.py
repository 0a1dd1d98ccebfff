"""The port's span log (``repro_torch.data.metrics``) on the CPU: a
micro-batch's spans through the stream, the scheduler's executors, the ART
call, the train step and the serve path; what tracing off costs; the
profiler ranges while a CPU profiler records; the clock anchor; and the
dry-run walker's view of the cost scopes.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context, TaskScheduler
from repro_torch.data import locktrace
from repro_torch.data import metrics as M
from repro_torch.kernels.art import ops as art_ops
from repro_torch.launch.train import assemble_batch
from repro_torch.training import build_serve_fns, build_train_step, init_state

# the labels port_bench/trace.py gives the program's functions, and its
# window's: no program range may take one of these names
BENCH_LABELS = {"art", "attention", "adamw", "flash_attention",
                "port_bench.window"}
BATCH_LEVEL = {"batch", "pump", "batch_fn", "sinks", "broker_commit",
               "assemble_batch", "train_step", "optimizer", "prefill",
               "decode", "task", "art"}
FINE = {"layer0", "layer1", "attention", "mlp", "ce0", "ce1",
        "blocked_attention", "decode_attention"}


@pytest.fixture(autouse=True)
def port_lock_order():
    locktrace.enable()
    try:
        yield
    finally:
        report = locktrace.disable().report()
    assert not report.cycles, (
        "lock-order cycles detected (potential deadlock):\n"
        + report.describe())


def _config():
    # remat "full" and tiles small enough that the train step runs the
    # blocked attention and a recompute, two CE chunks
    return get_config("internlm2-1.8b", reduced=True).replace(
        remat="full", attention_block_q=16, attention_block_kv=32)


def _model_stream():
    """A StreamingContext whose batches each run one train step and a
    served prefill with two decode steps, as the benchmark's drivers
    compose them; returns (context, run one batch)."""
    config = _config()
    opt = OptimizerConfig()
    holder = {"state": init_state(torch.Generator().manual_seed(0), config,
                                  opt)}
    train_step = build_train_step(config, opt)
    prefill, decode = build_serve_fns(config)
    broker = Broker()
    broker.create_topic("tokens", partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=2)
    sc.subscribe(["tokens"])
    rng = np.random.default_rng(0)

    def on_batch(rdd, info):
        batch = assemble_batch(rdd.collect(), config, "cpu")
        holder["state"], _ = train_step(holder["state"], batch)
        with torch.inference_mode():
            logits, cache = prefill(holder["state"]["params"],
                                    {"tokens": batch["tokens"][:, :24]},
                                    max_len=28)
            tok = logits[:, -1:].argmax(-1)
            for _ in range(2):
                logits, cache = decode(holder["state"]["params"], tok, cache)
                tok = logits[:, -1:].argmax(-1)
        return 1

    sc.foreach_batch(on_batch)

    def run_one():
        for _ in range(2):
            broker.produce("tokens", {"tokens": rng.integers(
                0, config.vocab_size, (160,), dtype=np.int32)})
        return sc.run_one_batch()
    return sc, run_one


@pytest.fixture(scope="module")
def model_batches():
    """One model batch with tracing off, one under a CPU profiler: their
    BatchSpans, the profiler's events, and the ranges entered meanwhile."""
    locktrace.enable()
    try:
        sc, run_one = _model_stream()
        run_one()
        off = sc.traces.last(1)[0]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_one()
        on = sc.traces.last(1)[0]
        return {"off": off, "on": on, "events": list(prof.events())}
    finally:
        locktrace.disable()


def _names(batch_span):
    return [s.name for s in batch_span.spans]


def test_torch_spans_tracing_off_enters_no_range_and_records_no_fine_span(
        monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(M, "_RecordFunctionFast", Counting)
    sc, run_one = _model_stream()
    run_one()
    assert entered == []
    names = set(_names(sc.traces.last(1)[0]))
    assert {"batch", "pump", "batch_fn", "assemble_batch", "train_step",
            "optimizer", "prefill", "decode"} <= names <= BATCH_LEVEL
    # a fine span off is the one shared no-op: nothing allocated
    assert M.fine_span("blocked_attention") is M._NULL_SPAN
    assert M.fine_span("decode_attention", device=True) is M._NULL_SPAN
    assert M.cost_scope("layer", 3) is M._NULL_SPAN
    # outside every batch a batch-level span records nothing either
    assert M.span("train_step") is M._NULL_SPAN


def test_torch_spans_off_and_on_record_the_batch_and_the_fine_spans(
        model_batches):
    off, on = model_batches["off"], model_batches["on"]
    assert not off.traced and on.traced
    assert not set(_names(off)) & FINE
    assert FINE <= set(_names(on))
    counts = collections.Counter(_names(on))
    assert counts["decode"] == 2 and counts["decode_attention"] == 2 * 2
    # each layer's attention: the train step's forward and its recompute,
    # the prefill, and the two decode steps
    assert counts["train_step"] == 1 and counts["attention"] == 2 * 5


def _program_events(events):
    return [ev for ev in events if ev.name.startswith(M.SPAN_PREFIX)
            and not ev.name.startswith(M.ANCHOR)]


def _program_parent(ev):
    up = ev.cpu_parent
    while up is not None and not up.name.startswith(M.SPAN_PREFIX):
        up = up.cpu_parent
    return None if up is None else up.name[len(M.SPAN_PREFIX):]


def test_torch_spans_ranges_nest_as_the_spans_do_with_the_prefix(
        model_batches):
    # the spans of the thread the profiler records (the RDD's collect runs
    # its task on an executor thread, whose operations it does not record)
    on, events = model_batches["on"], model_batches["events"]
    main = threading.get_native_id()
    logged = collections.Counter(
        (s.name, None if s.parent is None else s.parent.name)
        for s in on.spans if s.thread == main)
    ranged = collections.Counter(
        (ev.name[len(M.SPAN_PREFIX):], _program_parent(ev))
        for ev in _program_events(events))
    assert ranged == logged
    assert ("decode_attention", "attention") in ranged
    assert ("blocked_attention", "attention") in ranged


def test_torch_spans_no_range_is_named_as_a_benchmark_label(model_batches):
    names = {ev.name for ev in model_batches["events"]
             if ev.name.startswith("repro_torch")}
    assert names and all(n.startswith(M.SPAN_PREFIX) for n in names)
    assert not names & BENCH_LABELS


def _tomo_stream(executors: int = 3):
    """Batches of 6 slices in 3 partitions, each partition's ART call (the
    plain version on the CPU) on the scheduler's executor threads."""
    A = torch.rand(8, 16, generator=torch.Generator().manual_seed(0))
    broker = Broker()
    broker.create_topic("t", partitions=1)
    sc = StreamingContext(Context(scheduler=TaskScheduler(
        num_executors=executors, speculation=False)), broker,
        max_records_per_partition=6)
    sc.subscribe(["t"])

    def part(items):
        b = torch.stack([torch.full((8,), float(v)) for v in items])
        return art_ops.art_reconstruct(A, b, torch.zeros(len(items), 16))

    def on_batch(rdd, info):
        # the batch's collect is a task too, then one task a partition
        return sc.context.parallelize(rdd.collect(), 3).map_partitions(
            part).collect_partitions()

    sc.foreach_batch(on_batch)
    for i in range(12):
        broker.produce("t", i)
    return sc


def test_torch_spans_one_batch_shares_its_index_on_executor_threads():
    sc = _tomo_stream()
    sc.run_one_batch()
    sc.run_one_batch()
    main = threading.get_native_id()
    for b in sc.traces.last():
        assert {s.batch for s in b.spans} == {b.batch_index}
        tasks = [s for s in b.spans if s.name == "task"]
        assert sorted(s.attrs["partition"] for s in tasks) == [0, 0, 1, 2]
        assert all(s.attrs["attempt"] == 0 and not s.attrs["speculative"]
                   for s in tasks)
        assert all(s.thread != main and s.parent.name == "batch_fn"
                   for s in tasks)
        arts = [s for s in b.spans if s.name == "art"]
        assert len(arts) == 3 and len({s.parent.id for s in arts}) == 3
        assert {s.parent.id for s in arts} < {s.id for s in tasks}
        for s in arts:
            assert s.parent.start <= s.start <= s.end <= s.parent.end


def test_torch_spans_device_spans_read_none_on_the_cpu(model_batches):
    sc = _tomo_stream()
    sc.run_one_batch()
    d = sc.traces.last(1)[0].as_dict()
    arts = [s for s in d["spans"] if s["name"] == "art"]
    assert arts and all(s["device_s"] is None for s in arts)
    # off the card no sweep is counted in flight
    assert all("in_flight" not in s["attrs"] for s in arts)
    for b in (model_batches["off"], model_batches["on"]):
        device = [s for s in b.spans
                  if s.name in ("optimizer", "decode_attention")]
        assert device and all(s.device_s is None for s in device)


def test_torch_spans_outlive_their_context_through_recent_batches():
    sc = _tomo_stream()
    sc.run_one_batch()
    sc.run_one_batch()
    ids = [b.batch_index for b in sc.traces.last()]
    del sc
    recent = M.recent_batches(2)
    assert [b["batch_index"] for b in recent] == ids
    for b in recent:
        assert not b["traced"]
        assert [s["name"] for s in b["spans"]][:2] == ["batch", "pump"]
        assert sum(s["name"] == "task" for s in b["spans"]) == 1 + 3
        assert b["stages"]["pump"] == pytest.approx(
            next(s["end"] - s["start"] for s in b["spans"]
                 if s["name"] == "pump"))
    assert M.recent_batches(0) == []


def test_torch_spans_anchor_places_a_worker_thread_span():
    log = M.TraceLog()
    log.begin(0, 0).abandon()          # a span with tracing off first
    box = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = log.begin(1, 1)
        with rec.stage("batch_fn") as stage:
            def worker():
                with M.span("work", parent=stage) as s:
                    time.sleep(0.003)
                box["work"] = s
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with M.span("after") as after:
                time.sleep(0.001)
        rec.finish(1)
    events = list(prof.events())
    offset = M.anchor_offset_us(events)
    assert offset is not None
    ranges = {ev.name: ev for ev in events}
    work, stage_ev = box["work"], ranges[M.SPAN_PREFIX + "batch_fn"]
    after_ev = ranges[M.SPAN_PREFIX + "after"]
    # a span of the main thread lands on its own range within 100 µs ...
    assert abs(after.start * 1e6 + offset
               - after_ev.time_range.start) < 100
    assert abs(after.end * 1e6 + offset - after_ev.time_range.end) < 100
    # ... and the worker's inside the stage that waited for it, before
    # the main thread's next span
    assert stage_ev.time_range.start - 100 <= work.start * 1e6 + offset
    assert work.end * 1e6 + offset <= after_ev.time_range.start + 100
    assert work.batch == 1 and work.thread != threading.get_native_id()


# the enter and exit calls the dry-run's walker saw on this train step
# (2 layers, remat "full", 2 CE chunks) when cost_scope was a context
# manager of its own in repro_torch/utils.py
WALKER_BEFORE = [
    ("enter", "layer0"), ("enter", "attention"), ("exit", "attention"),
    ("enter", "mlp"), ("exit", "mlp"), ("exit", "layer0"),
    ("enter", "layer1"), ("enter", "attention"), ("exit", "attention"),
    ("enter", "mlp"), ("exit", "mlp"), ("exit", "layer1"),
    ("enter", "ce0"), ("exit", "ce0"), ("enter", "ce1"), ("exit", "ce1"),
    ("enter", "attention"), ("exit", "attention"), ("enter", "mlp"),
    ("exit", "mlp"), ("enter", "attention"), ("exit", "attention"),
    ("enter", "mlp"), ("exit", "mlp"), ("enter", "optimizer"),
    ("exit", "optimizer")]


@pytest.mark.parametrize("traced", [False, True])
def test_torch_spans_walker_sees_the_scopes_it_saw_before(traced):
    seen = []

    class Walker:
        def enter_scope(self, name):
            seen.append(("enter", name))

        def exit_scope(self, name):
            seen.append(("exit", name))

    config = get_config("internlm2-1.8b", reduced=True).replace(remat="full")
    opt = OptimizerConfig()
    state = init_state(torch.Generator().manual_seed(0), config, opt)
    step = build_train_step(config, opt)
    batch = {"tokens": torch.randint(0, config.vocab_size, (2, 160),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    walker = Walker()
    M.add_listener(walker)
    try:
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                step(state, batch)
        else:
            step(state, batch)
    finally:
        M.remove_listener(walker)
    assert seen == WALKER_BEFORE
