"""The port's windows, window-state store and restart-safe windowed path on
the CPU: counterparts of tests/test_data_window.py and
tests/test_window_state.py (its SIGKILL mid-window restart included), the
same records through the JAX package's Windower and the port's, and the
§III ``--restart`` entry point, whose windows are held to the JAX solver
replayed on the same frames.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import json
import multiprocessing as mp
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.ptycho import sim as jsim
from repro.apps.ptycho import solver as jsolver
from repro.core.dstream import BatchInfo as JaxBatchInfo
from repro.data import window as jax_window
from repro_torch.apps.ptycho.stream import parse_args, run_restart
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import BatchInfo, StreamingContext
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.sinks import NpzDirectorySink
from repro_torch.data.sources import SequenceSource
from repro_torch.data.state import (DurableStateStore, InMemoryStateStore,
                                    WindowState, WindowStateStore)
from repro_torch.data.window import WindowSpec, Windower, windowed


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


class _Counter(SequenceSource):
    """``total`` records ``(b"rec-%06d", i)``, as fast as polled."""

    def __init__(self, total: int) -> None:
        super().__init__()
        self._total = total

    def __len__(self) -> int:
        return self._total

    def record_at(self, i: int):
        return f"rec-{i:06d}".encode(), i


# -- windows (tests/test_data_window.py) --------------------------------------
def _batch(index, t):
    return BatchInfo(index=index, ranges=[], num_records=0, scheduled_at=t)


def collect_windows():
    fired = []

    def fn(records, info):
        fired.append((info.index, info.start, info.end, list(records),
                      info.batches, info.partial))
        return len(records)

    return fired, fn


def test_torch_window_tumbling_count_window():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=3), fn)
    assert w.push([0, 1], _batch(0, 0.0)) == []
    assert w.push([2, 3, 4], _batch(1, 0.1)) == [3]
    assert w.push([5], _batch(2, 0.2)) == [3]
    assert fired == [(0, 0.0, 3.0, [0, 1, 2], [0, 1], False),
                     (1, 3.0, 6.0, [3, 4, 5], [1, 2], False)]


def test_torch_window_sliding_count_window_overlaps():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=4, slide=2), fn)
    w.push(list(range(8)), _batch(0, 0.0))
    assert [rec for _, _, _, rec, _, _ in fired] == \
        [[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7]]
    assert [(s, e) for _, s, e, _, _, _ in fired] == \
        [(0.0, 4.0), (2.0, 6.0), (4.0, 8.0)]


def test_torch_window_count_window_flush_fires_partial():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=10), fn)
    w.push([1, 2, 3], _batch(0, 0.0))
    assert w.flush() == [3]
    assert fired[-1][3] == [1, 2, 3] and fired[-1][5] is True
    # partial-window contract: end is an exclusive bound on the contents —
    # one past the last record index for the count kind
    assert (fired[-1][1], fired[-1][2]) == (0.0, 3.0)
    assert w.flush() == []                      # nothing left


def test_torch_window_count_window_flush_end_after_fired_windows():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=4), fn)
    w.push(list(range(10)), _batch(0, 0.0))     # windows [0,4), [4,8) fire
    w.flush()
    assert fired[-1] == (2, 8.0, 10.0, [8, 9], [0], True)


def test_torch_window_time_window_flush_end_is_exclusive_bound():
    """Time-kind partial windows report the open window's scheduled bounds
    [start, start + size) — an exclusive bound on every buffered timestamp,
    exactly like a complete window (it used to report end = max(ts), a
    timestamp *inside* the window, breaking the [start, end) contract)."""
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=1.0, kind="time"), fn)
    w.push(["a"], _batch(0, 100.0))             # t=0.0
    w.push(["b"], _batch(1, 101.2))             # t=1.2 closes [0,1)
    w.push(["c"], _batch(2, 101.5))             # t=1.5, window [1,2) open
    w.flush()
    assert fired[0][1:3] == (0.0, 1.0)          # complete window
    index, start, end, recs, _, partial = fired[1]
    assert partial is True and recs == ["b", "c"]
    assert (start, end) == (1.0, 2.0)           # scheduled bounds, not max(ts)
    assert all(start <= t < end for t in (1.2, 1.5))


def test_torch_window_sliding_time_window_flush_bounds():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=2.0, slide=1.0, kind="time"), fn)
    w.push([1], _batch(0, 10.0))                # t=0
    w.push([2], _batch(1, 12.5))                # t=2.5 closes [0,2)
    w.flush()                                   # open window [1,3): [2]
    assert fired[-1][1:3] == (1.0, 3.0) and fired[-1][5] is True
    assert fired[-1][3] == [2]


def test_torch_window_tumbling_time_window():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=1.0, kind="time"), fn)
    w.push(["a"], _batch(0, 100.0))             # t=0.0
    w.push(["b"], _batch(1, 100.4))             # t=0.4
    assert fired == []                          # window [0,1) still open
    w.push(["c"], _batch(2, 101.2))             # t=1.2 closes [0,1)
    assert len(fired) == 1
    assert fired[0][3] == ["a", "b"] and (fired[0][1], fired[0][2]) == (0.0, 1.0)
    w.push(["d"], _batch(3, 102.5))             # t=2.5 closes [1,2)
    assert fired[1][3] == ["c"]


def test_torch_window_sliding_time_window():
    fired, fn = collect_windows()
    w = Windower(WindowSpec(size=2.0, slide=1.0, kind="time"), fn)
    w.push([1], _batch(0, 10.0))                # t=0
    w.push([2], _batch(1, 11.5))                # t=1.5
    w.push([3], _batch(2, 12.5))                # t=2.5 closes [0,2)
    w.push([4], _batch(3, 13.5))                # t=3.5 closes [1,3)
    assert [rec for _, _, _, rec, _, _ in fired] == [[1, 2], [2, 3]]


def test_torch_window_windowed_over_streaming_context():
    """'Reconstruct over the last K frame batches': sliding count window
    composed on a StreamingContext, fed by a subscribed source."""
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=5)
    sc.subscribe_source(_Counter(20), topic="t")
    wout = []
    sums = []
    sc.foreach_batch(windowed(WindowSpec(size=10, slide=5),
                              lambda recs, wi: sums.append(sum(recs)),
                              windower_out=wout))
    while not (sc.sources_exhausted and sc.lag("t") == 0):
        sc.run_one_batch()
    wout[0].flush()
    # windows [0,10), [5,15), [10,20), then flush of the residual [15,20)
    assert sums == [sum(range(10)), sum(range(5, 15)), sum(range(10, 20)),
                    sum(range(15, 20))]


def test_torch_window_time_windowed_over_streaming_context_fake_clock():
    """Time-based windows through the full StreamingContext, pinned by an
    injected fake clock: every batch's scheduled_at is scripted, so window
    boundaries (and which records fall in them) are exact, not timing-y."""
    clock = {"t": 100.0}
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=3,
                          clock=lambda: clock["t"])
    sc.subscribe_source(_Counter(12), topic="t")
    wout, fired = [], []
    sc.foreach_batch(windowed(
        WindowSpec(size=1.0, kind="time"),
        lambda recs, wi: fired.append((wi.start, wi.end, list(recs),
                                       wi.partial)),
        windower_out=wout))
    # 4 batches of 3 records at rel t = 0.0, 0.4, 0.8, 1.2
    while not (sc.sources_exhausted and sc.lag("t") == 0):
        assert sc.run_one_batch() is not None
        clock["t"] += 0.4
    assert [b.scheduled_at for b in sc.history] == pytest.approx(
        [100.0, 100.4, 100.8, 101.2])
    # the batch at rel 1.2 closed window [0, 1): records from rel 0.0/0.4/0.8
    assert fired == [(0.0, 1.0, list(range(9)), False)]
    wout[0].flush()
    assert fired[1][2] == [9, 10, 11] and fired[1][3] is True


def test_torch_window_sliding_time_windowed_over_streaming_context_fake_clock():
    clock = {"t": 50.0}
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=2,
                          clock=lambda: clock["t"])
    sc.subscribe_source(_Counter(10), topic="t")
    windows = []
    sc.foreach_batch(windowed(
        WindowSpec(size=2.0, slide=1.0, kind="time"),
        lambda recs, wi: windows.append((wi.start, list(recs)))))
    # 5 batches of 2 records at rel t = 0, 1, 2, 3, 4
    while not (sc.sources_exhausted and sc.lag("t") == 0):
        sc.run_one_batch()
        clock["t"] += 1.0
    # [0,2) closes at rel 2 (records of batches at 0,1); [1,3) at rel 3; ...
    assert windows == [(0.0, [0, 1, 2, 3]),
                       (1.0, [2, 3, 4, 5]),
                       (2.0, [4, 5, 6, 7])]


def test_torch_window_window_spec_validation():
    with pytest.raises(ValueError):
        WindowSpec(size=0)
    with pytest.raises(ValueError):
        WindowSpec(size=4, slide=-1)
    with pytest.raises(ValueError):
        WindowSpec(size=4, kind="session")


# -- window state (tests/test_window_state.py) --------------------------------
def _state(buf, evicted=0, t0=None, fired=0):
    return WindowState(buf=list(buf), evicted=evicted, t0=t0,
                       windows_fired=fired)


def _mk(vals, start=0):
    """Buffer entries for records ``vals`` arriving one per batch."""
    return [(v, 0.0, start + i) for i, v in enumerate(vals)]


# -- stores: protocol + round trip -------------------------------------------

def test_torch_wstate_inmemory_store_round_trip():
    store = InMemoryStateStore()
    assert isinstance(store, WindowStateStore)
    assert store.restore(None) is None
    s = _state(_mk([1, 2, 3]), evicted=5, t0=10.0, fired=2)
    ref = store.commit(7, s)
    assert ref == 7
    s.buf.append(("mutated", 0.0, 9))      # caller mutation must not leak in
    got = store.restore(7)
    assert got.buf == _mk([1, 2, 3]) and got.evicted == 5
    assert got.t0 == 10.0 and got.windows_fired == 2
    got.buf.clear()                        # nor leak back out
    assert store.restore(7).buf == _mk([1, 2, 3])
    assert store.restore(6) is None        # unknown ref: fresh start


def test_torch_wstate_durable_store_commit_restore_across_reopen(tmp_path):
    path = str(tmp_path / "w")
    with DurableStateStore(path) as store:
        store.commit(1, _state(_mk([0, 1])))
        store.commit(2, _state(_mk([0, 1, 2, 3])))
        store.commit(3, _state(_mk([2, 3, 4], start=2), evicted=2, fired=1))
    reopened = DurableStateStore(path)
    assert reopened.recovered_frames == 3      # snap + 2 deltas
    got = reopened.restore(3)
    assert got.buf == _mk([2, 3, 4], start=2)
    assert got.evicted == 2 and got.windows_fired == 1
    # restoring an older epoch rewinds AND truncates the newer frames
    reopened.close()
    store2 = DurableStateStore(path)
    got2 = store2.restore(2)
    assert got2.buf == _mk([0, 1, 2, 3]) and got2.evicted == 0
    store2.close()
    assert DurableStateStore(path).restore(3).buf == _mk([0, 1, 2, 3])


def test_torch_wstate_durable_store_restore_none_resets(tmp_path):
    path = str(tmp_path / "w")
    with DurableStateStore(path) as store:
        store.commit(1, _state(_mk([1, 2, 3])))
    store = DurableStateStore(path)
    # no checkpoint ref survived (e.g. corrupt checkpoint): state resets too,
    # keeping offsets and window state consistent (both empty)
    assert store.restore(None) is None
    assert os.path.getsize(os.path.join(path, "state.log")) == 0
    store.commit(1, _state(_mk([9])))
    assert store.restore(1).buf == _mk([9])
    store.close()


def test_torch_wstate_durable_store_unchanged_state_writes_nothing(tmp_path):
    store = DurableStateStore(str(tmp_path / "w"))
    s = _state(_mk([1, 2]), evicted=1, fired=1)
    assert store.commit(4, s) == 4
    size = os.path.getsize(store._file)
    assert store.commit(5, s) == 4         # previous ref: nothing new on disk
    assert os.path.getsize(store._file) == size
    assert store.commit(6, _state(_mk([1, 2, 3]), evicted=1, fired=1)) == 6
    store.close()


def test_torch_wstate_durable_store_torn_tail_truncated(tmp_path):
    path = str(tmp_path / "w")
    with DurableStateStore(path) as store:
        store.commit(1, _state(_mk([0, 1])))
        store.commit(2, _state(_mk([0, 1, 2])))
    with open(os.path.join(path, "state.log"), "ab") as f:
        f.write(b"\x00\x00\x00\x40TORN-DELTA-ONLY-PARTIALLY-WRITTEN")
    store = DurableStateStore(path)
    assert store.truncated_bytes > 0
    assert store.restore(2).buf == _mk([0, 1, 2])
    store.close()


def test_torch_wstate_durable_store_bit_flip_keeps_committed_prefix(tmp_path):
    path = str(tmp_path / "w")
    with DurableStateStore(path) as store:
        store.commit(1, _state(_mk([0, 1, 2])))
        store.commit(2, _state(_mk([0, 1, 2, 3, 4])))
    blob = bytearray(open(os.path.join(path, "state.log"), "rb").read())
    blob[-3] ^= 0x20                       # corrupt the delta frame
    with open(os.path.join(path, "state.log"), "wb") as f:
        f.write(blob)
    store = DurableStateStore(path)
    assert store.truncated_bytes > 0
    # epoch 2's delta is gone; epoch 1's snapshot still restores
    assert store.restore(2).buf == _mk([0, 1, 2])
    store.close()


def test_torch_wstate_durable_store_compaction_bounds_file(tmp_path):
    path = str(tmp_path / "w")
    store = DurableStateStore(path, snapshot_every=4)
    buf = []
    for e in range(1, 41):
        buf = buf[-3:] + [(e, 0.0, e)]     # sliding-ish: bounded buffer
        store.commit(e, _state(buf, evicted=max(0, e - 4)))
    # 40 commits, snapshot_every=4: the log holds <= 2 snapshots + 4 deltas,
    # never the whole history
    assert store.snapshots >= 8
    size = os.path.getsize(store._file)
    assert size < 8 * 1024
    assert store.restore(40).buf == buf
    store.close()
    # the last two compaction anchors both restore (crash on either side of
    # the caller's checkpoint write)
    reopened = DurableStateStore(path, snapshot_every=4)
    assert reopened.restore(40).buf == buf
    reopened.close()


def test_torch_wstate_durable_store_compaction_keeps_previous_committed_epoch(tmp_path):
    """The crash window the two-snapshot compaction exists for: the store
    compacts at epoch N, the process dies before the offset checkpoint
    publishes N — restore(N-1) must still work."""
    path = str(tmp_path / "w")
    store = DurableStateStore(path, snapshot_every=2)
    store.commit(1, _state(_mk([0])))
    store.commit(2, _state(_mk([0, 1])))
    store.commit(3, _state(_mk([0, 1, 2])))   # delta budget spent
    store.commit(4, _state(_mk([0, 1, 2, 3])))  # -> compaction [snap3, snap4]
    store.close()
    store = DurableStateStore(path)
    assert store.restore(4).buf == _mk([0, 1, 2, 3])   # checkpoint saw 4
    store.close()
    store = DurableStateStore(path)
    # checkpoint never saw 4: restoring 3 works AND truncates the epoch-4
    # snapshot for good (it is uncommitted state)
    assert store.restore(3).buf == _mk([0, 1, 2])
    store.close()
    store = DurableStateStore(path)
    assert store.restore(4).buf == _mk([0, 1, 2])      # 4 is gone now
    store.close()


def test_torch_wstate_durable_store_snapshot_on_rollback_shaped_change(tmp_path):
    """Counters moving backwards (caller rolled the windower back) cannot be
    expressed as a delta — the store must fall back to a snapshot, not
    extrapolate garbage."""
    store = DurableStateStore(str(tmp_path / "w"))
    store.commit(1, _state(_mk([0, 1, 2]), evicted=6, fired=2))
    store.commit(2, _state(_mk([9]), evicted=3, fired=1))   # went backwards
    store.close()
    store = DurableStateStore(str(tmp_path / "w"))
    got = store.restore(2)
    assert got.buf == _mk([9]) and got.evicted == 3 and got.windows_fired == 1
    store.close()


def test_torch_wstate_durable_store_validation(tmp_path):
    with pytest.raises(ValueError):
        DurableStateStore(str(tmp_path / "a"), fsync="sometimes")
    with pytest.raises(ValueError):
        DurableStateStore(str(tmp_path / "b"), snapshot_every=0)


# -- context integration: atomic (offsets, window state) ---------------------

def _windowed_context(broker, ckpt, store, fired, size=10, per_batch=7):
    sc = StreamingContext(Context(), broker, max_records_per_partition=per_batch,
                          checkpoint_path=ckpt)
    sc.subscribe(["t"])
    wout = []
    sc.foreach_batch(windowed(
        WindowSpec(size=size),
        lambda recs, wi: fired.append((wi.index, list(recs))),
        store=store, windower_out=wout))
    return sc, wout[0]


def test_torch_wstate_mid_window_restart_resumes_exactly(tmp_path):
    """The tentpole behavior, in-process: offsets checkpoint mid-window, the
    'process' dies, the restart restores the open window from the store and
    fires exactly the windows an uninterrupted run fires."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(40):
        broker.produce("t", i)
    ckpt = str(tmp_path / "ckpt.json")
    fired = []
    store = DurableStateStore(str(tmp_path / "w"))
    sc, _ = _windowed_context(broker, ckpt, store, fired)
    for _ in range(3):                     # 21 consumed: buf holds [20]
        sc.run_one_batch()
    assert [i for i, _ in fired] == [0, 1]
    store.close()                          # crash

    fired2 = []
    store2 = DurableStateStore(str(tmp_path / "w"))
    sc2, w2 = _windowed_context(broker, ckpt, store2, fired2)
    while sc2.run_one_batch() is not None:
        pass
    assert fired2 == [(2, list(range(20, 30))), (3, list(range(30, 40)))]
    assert w2.flush() == []                # nothing pending: 40 = 4 windows
    store2.close()


def test_torch_wstate_in_memory_store_loses_open_window_but_api_matches(tmp_path):
    """The degenerate path pins the pre-existing behavior: same wiring, but a
    'restart' (new store) drops the open window — the records consumed into
    it are gone. This is the hole DurableStateStore closes."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(40):
        broker.produce("t", i)
    ckpt = str(tmp_path / "ckpt.json")
    fired = []
    sc, _ = _windowed_context(broker, ckpt, InMemoryStateStore(), fired)
    for _ in range(3):
        sc.run_one_batch()
    fired2 = []
    sc2, w2 = _windowed_context(broker, ckpt, InMemoryStateStore(), fired2)
    while sc2.run_one_batch() is not None:
        pass
    w2.flush()
    flat = [v for _, recs in fired + fired2 for v in recs]
    assert 20 not in flat                  # record 20 was lost mid-window
    assert sorted(flat) == [v for v in range(40) if v != 20]


def test_torch_wstate_in_memory_path_spawns_no_threads(tmp_path):
    before = threading.active_count()
    test_torch_wstate_in_memory_store_loses_open_window_but_api_matches(tmp_path)
    assert threading.active_count() == before


def test_torch_wstate_failed_serial_sink_rolls_back_window_state(tmp_path):
    """A sink raising after the windower pushed must roll the window back:
    the replayed batch pushes the same records again and the window fires
    them once, not twice."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(12):
        broker.produce("t", i)
    ckpt = str(tmp_path / "ckpt.json")
    fired = []
    store = InMemoryStateStore()
    sc, _ = _windowed_context(broker, ckpt, store, fired, size=6, per_batch=6)
    boom = {"armed": True}

    def flaky_sink(info):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("transient sink failure")

    sc.add_sink(flaky_sink)
    with pytest.raises(RuntimeError):
        sc.run_one_batch()                 # window 0 fired, then sink blew up
    # nothing committed: offsets AND window state rolled back together
    assert sc.committed("t") == 0
    while sc.run_one_batch() is not None:
        pass
    # the replay re-fired window 0 with identical contents (idempotent by
    # index), and no record appears in two different windows
    assert fired[0] == fired[1] == (0, [0, 1, 2, 3, 4, 5])
    assert fired[2] == (1, [6, 7, 8, 9, 10, 11])
    assert len(fired) == 3


def test_torch_wstate_store_without_checkpoint_path_is_left_alone(tmp_path):
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(10):
        broker.produce("t", i)
    sc = StreamingContext(Context(), broker, max_records_per_partition=5)
    sc.subscribe(["t"])
    store = DurableStateStore(str(tmp_path / "w"))
    sc.foreach_batch(windowed(WindowSpec(size=5), lambda r, w: None,
                              store=store))
    while sc.run_one_batch() is not None:
        pass
    assert os.path.getsize(store._file) == 0   # nothing to commit against
    store.close()


def test_torch_wstate_restore_warns_when_ref_beyond_log(tmp_path, caplog):
    """A checkpoint ref with no frame on disk means a power loss outran the
    fsync policy (the checkpoint always fsyncs): restore must warn and fall
    back to the newest earlier state, never degrade silently."""
    path = str(tmp_path / "w")
    with DurableStateStore(path) as store:
        store.commit(1, _state(_mk([0, 1])))
    store = DurableStateStore(path)
    with caplog.at_level("WARNING"):
        got = store.restore(3)             # the epoch-3 frame never synced
    assert got.buf == _mk([0, 1])
    assert any("no frame for checkpoint ref 3" in r.message
               for r in caplog.records)
    store.close()


def test_torch_wstate_attach_warns_on_time_kind_restore_with_monotonic_clock(
        tmp_path, caplog):
    """time-kind t0 is a clock reading from the *previous* process; under
    the default monotonic clock that is meaningless after a restart — the
    attach path must say so at runtime, not only in docs."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(4):
        broker.produce("t", i)
    ckpt = str(tmp_path / "ckpt.json")
    store = DurableStateStore(str(tmp_path / "w"))
    clock = {"t": 50.0}
    sc = StreamingContext(Context(), broker, max_records_per_partition=2,
                          checkpoint_path=ckpt, clock=lambda: clock["t"])
    sc.subscribe(["t"])
    sc.foreach_batch(windowed(WindowSpec(size=100.0, kind="time"),
                              lambda r, w: None, store=store))
    sc.run_one_batch()                     # t0 = 50.0 committed
    store.close()

    store2 = DurableStateStore(str(tmp_path / "w"))
    with caplog.at_level("WARNING"):
        sc2 = StreamingContext(Context(), broker, max_records_per_partition=2,
                               checkpoint_path=ckpt)   # default clock
        sc2.subscribe(["t"])
        sc2.foreach_batch(windowed(WindowSpec(size=100.0, kind="time"),
                                   lambda r, w: None, store=store2))
    assert any("not comparable across restarts" in r.message
               for r in caplog.records)
    store2.close()
    # an injected clock is trusted: no warning
    caplog.clear()
    store3 = DurableStateStore(str(tmp_path / "w"))
    with caplog.at_level("WARNING"):
        sc3 = StreamingContext(Context(), broker, max_records_per_partition=2,
                               checkpoint_path=ckpt, clock=lambda: clock["t"])
        sc3.subscribe(["t"])
        sc3.foreach_batch(windowed(WindowSpec(size=100.0, kind="time"),
                                   lambda r, w: None, store=store3))
    assert not any("not comparable" in r.message for r in caplog.records)
    store3.close()


def test_torch_wstate_pipeline_flush_delivers_to_keyed_sinks_before_checkpoint(tmp_path):
    """The final partial window must reach the keyed sinks BEFORE the
    drained state is checkpointed (sinks-before-commit, same as batches):
    a sink failure leaves the windower and checkpoint un-drained so the
    flush is retryable, and a successful flush is on disk before the
    checkpoint forgets the window."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(13):
        broker.produce("t", i)
    sink = NpzDirectorySink(str(tmp_path / "npz"))
    calls = {"fail": 1}
    real_write = sink.write_batch

    def flaky_write(items, **kw):
        if calls["fail"] and any(k == "win-0001" for k, _ in items):
            calls["fail"] -= 1             # fail the flush delivery once
            raise OSError("disk hiccup")
        return real_write(items, **kw)

    sink.write_batch = flaky_write
    pipeline = NearRealTimePipeline(
        broker,
        PipelineConfig(topics=("t",), max_records_per_partition=5,
                       checkpoint_path=str(tmp_path / "ckpt.json")),
        lambda recs, wi, bridge: (f"win-{wi.index:04d}",
                                  {"n": len(recs)}),
        window=WindowSpec(size=10),
        bridge=TorchBridge(device=torch.device("cpu")),
        window_state=DurableStateStore(str(tmp_path / "w")),
        sinks=[sink])
    pipeline.run_until_drained(producer_done=lambda: True, idle_timeout=0.05)
    assert sink.keys_on_disk() == ["win-0000"]      # full window delivered
    epoch_before = pipeline.streaming._progress.epoch
    with pytest.raises(OSError):
        pipeline.flush_windows()           # sink failed -> nothing committed
    assert pipeline.streaming._progress.epoch == epoch_before
    assert len(pipeline.windower._buf) == 3         # flush rolled back
    results = pipeline.flush_windows()     # retry succeeds
    assert [k for k, _ in results] == ["win-0001"]
    assert sink.keys_on_disk() == ["win-0000", "win-0001"]
    assert pipeline.streaming._progress.epoch == epoch_before + 1
    assert pipeline.flush_windows() == []  # drained: idempotent
    pipeline.close()


# -- crash: SIGKILL mid-window ------------------------------------------------

_WINDOW = 30
_TOTAL = 600


def _fire_to_dir(out_dir):
    """Window fn: record each fired window idempotently by index — the keyed
    sink discipline that upgrades replays to exactly-once."""
    def fn(records, winfo):
        tmp = os.path.join(out_dir, f".win-{winfo.index:04d}.tmp")
        with open(tmp, "w") as f:
            json.dump(records, f)
        # analyze: ok replace-without-fsync - atomicity vs the reader below, not crash durability
        os.replace(tmp, os.path.join(out_dir, f"win-{winfo.index:04d}.json"))
    return fn


def _run_windowed(root, per_batch_sleep=0.0, max_batches=None):
    broker = Broker(log_factory=DurableLogFactory(os.path.join(root, "wal")))
    DurableLogFactory(os.path.join(root, "wal")).restore(broker)
    store = DurableStateStore(os.path.join(root, "wstate"))
    sc = StreamingContext(Context(), broker, max_records_per_partition=7,
                          checkpoint_path=os.path.join(root, "ckpt.json"))
    sc.subscribe(["t"])
    sc.foreach_batch(windowed(WindowSpec(size=_WINDOW),
                              _fire_to_dir(os.path.join(root, "windows")),
                              store=store))
    n = 0
    while sc.run_one_batch() is not None:
        n += 1
        if per_batch_sleep:
            time.sleep(per_batch_sleep)
        if max_batches is not None and n >= max_batches:
            break
    store.close()


def _crash_consumer(root):
    """Child: consume slowly until SIGKILLed mid-window."""
    _run_windowed(root, per_batch_sleep=0.05)


def _windows_on_disk(root):
    out = {}
    wdir = os.path.join(root, "windows")
    for name in sorted(os.listdir(wdir)):
        if name.startswith("win-") and name.endswith(".json"):
            with open(os.path.join(wdir, name)) as f:
                out[int(name[4:-5])] = json.load(f)
    return out


def test_torch_wstate_sigkill_mid_window_restart_fires_identical_windows(tmp_path):
    """The acceptance test: records live in a durable-log broker, window
    state in a DurableStateStore, offsets in the epoch checkpoint. SIGKILL
    the consumer mid-window; the restarted pipeline must fire the exact
    window set a never-crashed run fires — nothing lost off the open window,
    nothing duplicated into another one."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "windows"))
    producer = Broker(log_factory=DurableLogFactory(os.path.join(root, "wal")))
    producer.create_topic("t", 1)
    producer.produce_many("t", [(None, i) for i in range(_TOTAL)], partition=0)

    proc = mp.get_context("spawn").Process(target=_crash_consumer,
                                           args=(root,), daemon=True)
    proc.start()
    ckpt = os.path.join(root, "ckpt.json")
    deadline = time.monotonic() + 120
    killed_at = None
    while time.monotonic() < deadline:
        if not proc.is_alive():
            pytest.fail("consumer drained before it could be killed")
        try:
            with open(ckpt) as f:
                consumed = sum(sum(v) for v in json.load(f)["offsets"].values())
        except (OSError, ValueError, KeyError):
            consumed = 0
        # kill only once the open window is non-empty: offsets committed past
        # a window boundary with records accumulated toward the next one
        if consumed >= 3 * _WINDOW and consumed % _WINDOW != 0:
            killed_at = consumed
            os.kill(proc.pid, signal.SIGKILL)
            break
        time.sleep(0.002)
    else:
        proc.kill()
        pytest.fail("never caught the consumer mid-window")
    proc.join(timeout=30)
    pre_crash = _windows_on_disk(root)
    assert pre_crash, "no window fired before the kill"

    # restart in-process over the same wal/checkpoint/state dirs
    _run_windowed(root)

    got = _windows_on_disk(root)
    expect = {k: list(range(k * _WINDOW, (k + 1) * _WINDOW))
              for k in range(_TOTAL // _WINDOW)}
    assert got == expect, (
        f"killed at offset {killed_at}: restarted run must reproduce the "
        f"exact uncrashed window set")


def test_torch_wstate_delta_when_a_window_evicts_what_its_batch_pushed(
        tmp_path):
    """Batches of 21 into windows of 64 (the §III restart at Table II
    size): the commit whose batch fires window 0 evicts 64 records, one of
    them pushed by that same batch, so more records were appended than are
    left buffered. The delta must carry every buffered record; each commit
    restores exactly, from the port's store and from the reference's
    reading the port's file."""
    from repro.data.state import DurableStateStore as JaxDurableStateStore
    w = Windower(WindowSpec(size=64), lambda recs, info: None)
    store = DurableStateStore(str(tmp_path / "w"))
    truth = {}
    for b in range(7):
        w.push(list(range(21 * b, 21 * b + 21)),
               BatchInfo(index=b, ranges=[], num_records=21))
        truth[b + 1] = w.state()
        store.commit(b + 1, truth[b + 1])
    store.close()
    assert truth[4].evicted == 64 and len(truth[4].buf) == 20
    for epoch in sorted(truth, reverse=True):   # restore truncates: newest
        for cls in (DurableStateStore, JaxDurableStateStore):  # first
            with cls(str(tmp_path / "w")) as reopened:
                got = reopened.restore(epoch)
            assert (got.buf, got.evicted) == (truth[epoch].buf,
                                              truth[epoch].evicted), epoch


# -- held against the JAX package ---------------------------------------------
_PUSHES = [(0, 100.0, 3), (1, 100.4, 0), (2, 100.9, 5), (3, 101.3, 2),
           (4, 102.6, 7), (5, 102.7, 1), (6, 104.2, 4)]


@pytest.mark.parametrize("spec", [
    dict(size=4), dict(size=5, slide=2), dict(size=1.0, kind="time"),
    dict(size=2.0, slide=0.5, kind="time")],
    ids=["count", "count-sliding", "time", "time-sliding"])
def test_torch_windows_fire_as_the_reference_does(spec):
    """The same records, batch by batch with fixed schedule times, through
    the reference's Windower and the port's fire the same windows (index,
    bounds, records, batches, partial), leave the same state and flush the
    same tail."""
    fired = {"ref": [], "port": []}

    def fn(name):
        def record(records, info):
            fired[name].append((info.index, info.start, info.end,
                                list(records), info.batches, info.partial))
            return len(records)
        return record

    ref = jax_window.Windower(jax_window.WindowSpec(**spec), fn("ref"))
    port = Windower(WindowSpec(**spec), fn("port"))
    value = 0
    for index, t, n in _PUSHES:
        recs = list(range(value, value + n))
        value += n
        got_ref = ref.push(recs, JaxBatchInfo(index=index, ranges=[],
                                              num_records=n, scheduled_at=t))
        got_port = port.push(recs, BatchInfo(index=index, ranges=[],
                                             num_records=n, scheduled_at=t))
        assert got_port == got_ref
        assert vars(port.state()) == vars(ref.state())
    assert port.flush() == ref.flush()
    assert fired["port"] == fired["ref"]
    assert len(fired["ref"]) >= 3


@pytest.fixture(scope="module")
def restart_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("restart")
    args = parse_args(["--restart", "--fast", "--out", str(out)])
    return args, run_restart(args, device="cpu")


def test_torch_restart_fast_fires_the_reference_window_set(restart_run):
    """A spawned CPU consumer is SIGKILLed mid-window; the resumed run ends
    with the reference's window set: 3 windows of 27 frames at 81 frames,
    each fired once across the two processes."""
    args, res = restart_run
    assert (res["n_frames"], res["window"], res["batch"]) == (81, 27, 9)
    assert res["kill_offset"] > 27 and res["kill_offset"] % 27 != 0
    want = {f"win-{k:04d}": list(range(27 * k, 27 * (k + 1)))
            for k in range(3)}
    assert {k: w["frames"] for k, w in res["windows"].items()} == want
    assert res["windows_at_crash"]
    assert set(res["windows_at_crash"]) < set(want)
    # the resumed run fires every window not yet on disk, and no earlier one
    missing = set(want) - set(res["windows_at_crash"])
    assert missing <= set(res["fired_on_resume"]) <= set(want)
    assert res["launches"] == {"modulus_project": 0, "overlap_products": 0,
                               "raar_combine": 0, "art_sweep": 0,
                               "flash_attention": 0}     # CPU: plain
    root = os.path.join(args.out, "ptycho-restart")
    assert DurableLogFactory(os.path.join(root, "wal")).topics_on_disk() \
        == {"frames": 1}


def test_torch_restart_window_errors_match_jax_replay(restart_run):
    """Each window's Fourier error, whichever process fired it, is the JAX
    raar_step's on the same frames (warm start from init_waves, the true
    probe), within the tolerance of tests/test_torch_stream.py."""
    args, res = restart_run
    prob = jsim.simulate(args.obj_size, args.probe_size, args.scan_step)
    cfg = jsolver.SolverConfig(beta=0.75, iterations=args.iters_per_batch,
                               use_pallas=False)
    obj_shape = prob.object_true.shape
    step = jax.jit(lambda psi, mag, pos, probe, it: jsolver.raar_step(
        psi, mag, pos, probe, obj_shape, cfg, it))
    positions = jnp.asarray(prob.positions)
    for key, win in sorted(res["windows"].items()):
        ids = np.asarray(win["frames"])
        mags, probe = prob.magnitudes[ids], prob.probe_true
        psi = jsolver.init_waves(mags, probe)
        for it in range(args.iters_per_batch):
            psi, _, probe, err = step(psi, mags, positions[ids], probe, it)
        np.testing.assert_allclose(win["fourier_err"], float(err), rtol=0,
                                   atol=1e-3, err_msg=key)


def test_torch_restart_without_fast_keeps_the_given_size():
    """Unlike the reference, ``--restart`` alone does not shrink the run;
    ``--restart --fast`` does."""
    args = parse_args(["--restart"])
    assert (args.frames, args.obj_size, args.batch_frames) == (512, 256, 64)
    args = parse_args(["--restart", "--fast"])
    assert (args.frames, args.obj_size, args.batch_frames) == (81, 96, 27)


def test_torch_restart_with_a_batch_that_does_not_divide_the_window(
        tmp_path):
    """Windows of 28 over batches of 9: a window fires mid-batch, so the
    open window restored after the SIGKILL starts inside the batch that
    fired the last one; the run still ends with the uncrashed set, the
    partial tail included."""
    args = parse_args(["--restart", "--frames", "81", "--obj-size", "96",
                       "--probe-size", "32", "--scan-step", "8",
                       "--batch-frames", "28", "--iters-per-batch", "2",
                       "--out", str(tmp_path)])
    res = run_restart(args, device="cpu")
    assert (res["window"], res["batch"]) == (28, 9)
    assert res["kill_offset"] > 28 and res["kill_offset"] % 28 != 0
    assert {k: w["frames"] for k, w in res["windows"].items()} == {
        "win-0000": list(range(28)), "win-0001": list(range(28, 56)),
        "win-partial-0002": list(range(56, 81))}
