"""Fault tolerance and elasticity for the compute plane.

The counterpart of ``repro/core/fault.py``. The data plane heals itself
(RDD lineage and replayable broker offsets); this module covers the
*collective* side, where one dead rank stalls everyone:

* :class:`Watchdog`: a heartbeat monitor over the PMI server; missed
  heartbeats bump the PMI generation.
* :class:`ElasticController`: owns the worker set; after a generation bump
  it builds a new bridge over the survivors (or the grown set), and the
  caller restores the last checkpoint onto it and resumes. Checkpoint and
  restart is the elasticity that works for collective programs: half an
  all-reduce cannot be recomputed from lineage.
* :func:`run_with_recovery`: drives a step function, injects worker
  failures between steps, rebuilds the bridge and restores.
* :class:`LagPolicy`: closes the loop with the *data* plane: sustained
  ingest lag (or records shed under the drop and sample policies) grows the
  worker set instead of shedding data, and a drained pipeline shrinks it,
  with hysteresis so the controller never flaps. Its decisions are pure
  and are the reference's.

A worker is a slot of the bridge's local ranks: a device of this process
(``TorchBridge(devices=...)``), several of them on one card where the card
is all there is, as the reference's workers are virtual devices.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.bridge import TorchBridge
from repro_torch.core.pmi import PMIServer
from repro_torch.utils import get_logger

log = get_logger(__name__)


class WorkerFailure(RuntimeError):
    def __init__(self, worker_id: str) -> None:
        super().__init__(f"worker {worker_id} failed")
        self.worker_id = worker_id


class Watchdog:
    """Background heartbeat checker over the PMI server."""

    def __init__(self, pmi: PMIServer, interval: float = 0.5,
                 on_failure: Callable[[list[str]], None] | None = None) -> None:
        self.pmi = pmi
        self.interval = interval
        self.on_failure = on_failure
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            failed = self.pmi.check_heartbeats()
            if failed and self.on_failure:
                self.on_failure(failed)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


@dataclass
class ElasticEvent:
    generation: int
    world: int
    reason: str
    step: int


class ElasticController:
    """Re-forms the worker set across PMI generations.

    Generation g with W alive workers runs a bridge over ``devices[:W]``.
    ``devices`` defaults to the visible CUDA devices; a caller that wants
    more workers than cards passes a device more than once (the worker
    slots of one card), and on the CPU ``[torch.device("cpu")] * n``."""

    def __init__(self, num_workers: int | None = None,
                 initial_workers: int | None = None,
                 devices: Sequence[str | torch.device] | None = None
                 ) -> None:
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError(
                    "no CUDA device is visible; pass devices= (e.g. "
                    "[torch.device('cpu')] * n) to run on the CPU")
        self.devices = [torch.device(d) for d in devices]
        self.max_workers = num_workers or len(self.devices)
        if self.max_workers > len(self.devices):
            raise ValueError(
                f"{self.max_workers} workers requested, "
                f"{len(self.devices)} devices")
        if initial_workers is not None and not (
                1 <= initial_workers <= self.max_workers):
            raise ValueError(
                f"initial_workers {initial_workers} outside "
                f"[1, {self.max_workers}]")
        self.pmi = PMIServer(world_size=self.max_workers)
        # start shrunk when asked: the elastic scale-out begins on a
        # minimal worker set and lets LagPolicy grow it under load
        self.alive = list(range(initial_workers or self.max_workers))
        self.events: list[ElasticEvent] = []
        self._bridge: TorchBridge | None = None

    @property
    def world(self) -> int:
        return len(self.alive)

    def bridge(self) -> TorchBridge:
        if self._bridge is None:
            self._bridge = TorchBridge(devices=self.devices[:self.world])
        return self._bridge

    def fail_workers(self, n: int, step: int = -1) -> None:
        """Simulate n worker deaths (drops from the tail)."""
        if n >= self.world:
            raise ValueError("cannot fail every worker")
        self.alive = self.alive[: self.world - n]
        self._bridge = None
        self.events.append(ElasticEvent(len(self.events) + 1, self.world,
                                        f"failed {n} workers", step))
        log.info("elastic: shrank to %d workers", self.world)

    def add_workers(self, n: int, step: int = -1) -> None:
        """Scale out (workers re-join or capacity added)."""
        new = min(self.max_workers, self.world + n)
        self.alive = list(range(new))
        self._bridge = None
        self.events.append(ElasticEvent(len(self.events) + 1, self.world,
                                        f"grew to {new} workers", step))
        log.info("elastic: grew to %d workers", self.world)


@dataclass
class LagObservation:
    """One policy tick: what was seen and what was decided."""
    now: float
    lag: int
    shed: int          # records dropped/sampled-out since the previous tick
    delta: int         # worker delta: requested by observe(), applied by drive()


class LagPolicy:
    """Hysteresis controller from ingest lag to worker-set size.

    Consumes the backpressure signals :class:`~repro_torch.data.ingest
    .IngestRunner` exposes (current per-topic lag via ``lag_snapshot()``,
    cumulative drop/sample counts via ``metrics``) and drives
    :meth:`ElasticController.add_workers` / :meth:`ElasticController
    .fail_workers`:

    * scale **up** by ``step`` after ``sustain`` consecutive observations
      with ``lag >= scale_up_lag`` *or* shed records (under the drop/sample
      policies overload shows up as shedding, not lag — both mean the
      consumer is too small);
    * scale **down** by ``step`` after ``sustain`` consecutive observations
      with ``lag <= scale_down_lag`` and nothing shed (the pipeline
      drained);
    * inside the band ``(scale_down_lag, scale_up_lag)`` the streak counters
      reset — a noisy signal bouncing around a watermark never flaps;
    * after any scale event, observations inside ``cooldown`` seconds are
      ignored entirely, so the re-formed worker set gets to prove itself before
      the next decision.

    The clock is injectable (``clock=``) and every ``observe``/``drive``
    accepts an explicit ``now=`` — decisions are a pure function of the fed
    signal, which is what makes the scripted tests deterministic.
    """

    def __init__(self, scale_up_lag: int, scale_down_lag: int, *,
                 sustain: int = 3, cooldown: float = 10.0, step: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if scale_down_lag >= scale_up_lag:
            raise ValueError(
                f"scale_down_lag {scale_down_lag} must be < scale_up_lag "
                f"{scale_up_lag} (the hysteresis band)")
        if sustain < 1 or step < 1:
            raise ValueError("sustain and step must be >= 1")
        self.scale_up_lag = scale_up_lag
        self.scale_down_lag = scale_down_lag
        self.sustain = sustain
        self.cooldown = cooldown
        self.step = step
        self._clock = clock
        self._above = 0                  # consecutive overloaded ticks
        self._below = 0                  # consecutive drained ticks
        self._last_event_at: float | None = None
        self._shed_seen = 0              # cumulative shed already accounted
        self.history: list[LagObservation] = []

    # -- pure decision ------------------------------------------------------
    def _decide(self, lag: int, shed: int, now: float) -> int:
        """Update streaks and return the delta the signal calls for — the
        event (streak reset + cooldown start) is committed separately, so a
        decision the controller cannot apply (already at max/min) does not
        burn a cooldown it never earned."""
        in_cooldown = (self._last_event_at is not None
                       and now - self._last_event_at < self.cooldown)
        if in_cooldown:
            return 0
        if lag >= self.scale_up_lag or shed > 0:
            self._above += 1
            self._below = 0
            if self._above >= self.sustain:
                return self.step
        elif lag <= self.scale_down_lag:
            self._below += 1
            self._above = 0
            if self._below >= self.sustain:
                return -self.step
        else:                            # inside the band: streaks reset
            self._above = self._below = 0
        return 0

    def _commit(self, now: float) -> None:
        self._above = self._below = 0
        self._last_event_at = now

    def observe(self, lag: int, shed: int = 0, now: float | None = None) -> int:
        """Feed one observation; returns the requested worker delta
        (``+step``, ``-step`` or ``0``)."""
        now = self._clock() if now is None else now
        delta = self._decide(lag, shed, now)
        if delta:
            self._commit(now)
        self.history.append(LagObservation(now, lag, shed, delta))
        return delta

    # -- wired decision -----------------------------------------------------
    def drive(self, controller: "ElasticController", runner: Any = None,
              lag: int | None = None, now: float | None = None) -> int:
        """One tick against live signals: read ``runner``'s lag + shed
        deltas (or take ``lag`` directly), decide, and apply the decision to
        ``controller``. Returns the worker delta actually applied."""
        shed = 0
        if runner is not None:
            if lag is None:
                lag = max(runner.lag_snapshot().values(), default=0)
            total_shed = sum(m.dropped + m.sampled_out
                             for m in runner.metrics)
            shed = max(0, total_shed - self._shed_seen)
            self._shed_seen = total_shed
        if lag is None:
            raise ValueError("drive() needs a runner or an explicit lag")
        now = self._clock() if now is None else now
        delta = self._decide(lag, shed, now)
        applied = 0
        if delta > 0:
            applied = min(delta, controller.max_workers - controller.world)
            if applied > 0:
                controller.add_workers(applied)
        elif delta < 0:
            # never fail the last worker
            applied = -min(-delta, controller.world - 1)
            if applied < 0:
                controller.fail_workers(-applied)
        # only an APPLIED change starts the cooldown: a decision clamped to
        # nothing (controller already at its bound) keeps the streak alive,
        # so the policy reacts immediately once headroom appears
        if applied:
            self._commit(now)
        self.history.append(LagObservation(now, lag, shed, applied))
        return applied


def run_with_recovery(
    controller: ElasticController,
    init_state: Callable[[TorchBridge], Any],
    step_fn: Callable[[TorchBridge, Any, int], Any],
    num_steps: int,
    save_fn: Callable[[Any, int], None],
    restore_fn: Callable[[TorchBridge], tuple[Any, int]],
    checkpoint_every: int = 5,
    failure_plan: dict[int, int] | None = None,
) -> tuple[Any, list[ElasticEvent]]:
    """Drive ``step_fn`` to ``num_steps`` with elastic checkpoint/restart.

    ``failure_plan[step] = n`` injects n worker failures *before* that step.
    On failure the state is restored from the last checkpoint on the new
    (smaller) worker set and the lost steps are re-executed — exactly the recovery
    a SLURM-level requeue would perform, compressed into one process.
    """
    failure_plan = dict(failure_plan or {})
    bridge = controller.bridge()
    state = init_state(bridge)
    step = 0
    save_fn(state, step)
    while step < num_steps:
        if step in failure_plan and failure_plan[step] > 0:
            n = failure_plan.pop(step)
            controller.fail_workers(n, step=step)
            bridge = controller.bridge()
            state, step = restore_fn(bridge)
            log.info("elastic: restored at step %d on world %d", step,
                     controller.world)
            continue
        state = step_fn(bridge, state, step)
        step += 1
        if step % checkpoint_every == 0 or step == num_steps:
            save_fn(state, step)
    return state, controller.events
