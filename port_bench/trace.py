"""Reduction of a ``torch.profiler`` trace to the benchmark's device numbers.

Copied from ``chip_smoke.py`` and kept here, where later changes to the
program cannot move them: ``labelled`` is its ``_labelled`` (each listed
function of the program runs under a ``record_function`` of its label
while the block is open), and ``device_split`` its ``_train_split``
generalised to any labels: a kernel's time goes to the nearest labelled
caller of the host call that launched it, and a backward node gives its
kernels to the label under which its forward operation ran (matched by
thread and sequence number, recomputed forward operations included). A
kernel launched outside every label is credited to no label. A launch on
a thread whose operations the profiler does not record (the
``TaskScheduler``'s executors) goes to the labelled call whose host
interval holds it.

Busy time is the union of the device's kernel and copy intervals, so two
overlapping kernels are not counted twice; the idle share is one minus
busy over the traced window's wall time (``chip_smoke.py``'s arithmetic).
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Iterator

import numpy as np

WINDOW_LABEL = "port_bench.window"
BACKWARD = "autograd::engine::evaluate_function"
MAX_NAMED_GAPS = 500
TOP = 10                # entries of each breakdown list


@contextlib.contextmanager
def labelled(parts: dict[str, tuple[str, str]],
             calls: list | None = None) -> Iterator[None]:
    """Every call of ``module.name`` for each ``label: (module, name)``
    runs under ``record_function(label)`` inside the block; with
    ``calls``, each call also appends (label, its start and end by
    ``time.perf_counter``), for calls on threads the profiler does not
    record operations on."""
    from torch.profiler import record_function

    saved = []
    for label, (mod, name) in parts.items():
        module = importlib.import_module(mod)
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                with record_function(_label):
                    return _fn(*args, **kw)
            finally:
                if calls is not None:
                    calls.append((_label, t0, time.perf_counter()))

        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_split(prof: Any, labels: set[str] | dict,
                 calls: list | None = None,
                 window_t0: float | None = None) -> dict[str, Any]:
    """A profiled window's device numbers, in seconds: ``busy_s`` (the union
    of the device's intervals inside the window), ``window_s`` (the wall
    time of the ``WINDOW_LABEL`` span), ``labels`` (device time by label),
    ``launches`` (kernels by label), ``device_ops`` (the ``top`` device
    operations by time) and ``idle_gaps`` (the idle time inside the window
    by what the host was doing meanwhile: the innermost operation running
    at the gap's middle). Empty when the trace holds no window span or no
    device event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    labels = set(labels)
    events = list(prof.events() or ())
    window = [ev for ev in events if ev.device_type == cpu
              and ev.name == WINDOW_LABEL]
    if not window:
        return {}
    w0 = min(ev.time_range.start for ev in window)
    w1 = max(ev.time_range.end for ev in window)
    device = [ev for ev in events if ev.device_type == cuda
              and not ev.name.startswith("ProfilerStep")
              and ev.name not in labels and ev.name != WINDOW_LABEL
              and ev.time_range.start < w1 and ev.time_range.end > w0]
    if not device:
        return {}
    # the forward operations run under each label, by (thread, sequence
    # number): the keys by which backward nodes name their forward op
    ops_in = {label: set() for label in labels}
    for ev in events:
        if ev.device_type != cpu or ev.sequence_nr < 0:
            continue
        up = ev.cpu_parent
        while up is not None:
            if up.name in labels:
                ops_in[up.name].add((ev.thread, ev.sequence_nr))
                break
            up = up.cpu_parent

    def label_of(ev: Any) -> str | None:
        """The nearest label among ``ev`` and its callers; a backward node
        first gives its work to the label its forward op ran under."""
        up = ev
        while up is not None:
            if up.name in labels:
                return up.name
            if up.name.startswith(BACKWARD):
                key = (up.fwd_thread, up.sequence_nr)
                return next((lb for lb, ops in ops_in.items()
                             if key in ops), None)
            up = up.cpu_parent
        return None

    # each kernel's label by the host call that launched it (the same
    # correlation id) and that call's callers. A label none of whose
    # kernels is found so has its calls on threads whose operations the
    # profiler does not record (the executors'): a kernel with no label is
    # its when launched inside one of its calls' host intervals,
    # ``calls``' clock put on the trace's by the window's start. The trace
    # numbers such threads apart from the host's, so any launch inside the
    # interval counts: a fill kernel of a few microseconds another
    # executor launches meanwhile may count with it.
    launch = {ev.id: ev for ev in events
              if ev.device_type == cpu and "Launch" in ev.name}
    kernels = [ev for ev in device
               if not ev.name.startswith(("Memcpy", "Memset"))]
    owner = {id(ev): label_of(launch[ev.id]) if ev.id in launch else None
             for ev in kernels}
    found = {owner[id(ev)] for ev in kernels}
    shift = w0 - (window_t0 or 0.0) * 1e6
    intervals = sorted((a * 1e6 + shift, b * 1e6 + shift, label)
                       for label, a, b in calls or () if label not in found)
    for ev in kernels:
        if owner[id(ev)] is None and intervals and ev.id in launch:
            t = launch[ev.id].time_range.start
            owner[id(ev)] = next((lb for a, b, lb in intervals
                                  if a <= t <= b), None)
    by_label = dict.fromkeys(labels, 0.0)
    launches = dict.fromkeys(labels, 0)
    by_name: dict[str, float] = {}
    for ev in device:
        us = ev.time_range.elapsed_us()
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        label = owner.get(id(ev))
        if label is not None:
            by_label[label] += us
            launches[label] += 1
    merged = _merge([(max(ev.time_range.start, w0),
                      min(ev.time_range.end, w1)) for ev in device])
    busy_us = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [ev for ev in events if ev.device_type == cpu
            and ev.name != WINDOW_LABEL
            and not ev.name.startswith("ProfilerStep")]
    starts = np.array([ev.time_range.start for ev in host], dtype=float)
    ends = np.array([ev.time_range.end for ev in host], dtype=float)
    idle: dict[str, float] = {}
    # the longest gaps named one by one, the rest together
    gaps.sort(key=lambda g: g[0] - g[1])
    for i, (a, b) in enumerate(gaps):
        if i >= MAX_NAMED_GAPS:
            name = "shorter gaps"
        else:
            mid = (a + b) / 2
            inner = np.flatnonzero((starts <= mid) & (ends > mid))
            name = (host[inner[np.argmin(ends[inner] - starts[inner])]].name
                    if inner.size else "no traced host operation")
        idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(d: dict[str, float]) -> list[list]:
        return [[n, us / 1e6] for n, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "labels": {k: v / 1e6 for k, v in by_label.items()},
            "launches": launches, "device_ops": ranked(by_name),
            "idle_gaps": ranked(idle)}
