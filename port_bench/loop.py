"""What every driver shares: the measured window, the traced units after
it, and the release of the program's state before the reference runs."""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Callable

from port_bench import trace as tr


def window(unit: Callable[[], float], seconds: float
           ) -> tuple[float, float, int]:
    """Run ``unit`` (one batch or step, ending with its result on the
    host; it returns the work it completed) until ``seconds`` have passed,
    ending at the first unit boundary at or after them. Returns (the
    window's seconds, the work completed, the units run)."""
    t0 = time.perf_counter()
    work, units = 0.0, 0
    while True:
        work += unit()
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed, work, units


def traced(unit: Callable[[], Any], units: int, labels: dict,
           launched: Callable[[], int] | None = None) -> dict:
    """``units`` more units under the profiler, after one traced and
    dropped (a trace's first step can miss launches), with each label's
    function of the program under a span of its name. Returns
    ``trace.device_split``'s numbers, the calls of each label's function
    in the traced units as ``calls``, and ``launched``'s count over them
    as ``expected`` beside the launches the trace saw. A trace that saw
    fewer launches than were made is taken again, once."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    split: dict = {}
    for _ in range(2):
        calls: list = []
        with tr.labelled(labels, calls), profile(
                activities=acts,
                schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            unit()
            prof.step()
            before = launched() if launched else 0
            t0 = time.perf_counter()
            with record_function(tr.WINDOW_LABEL):
                for _ in range(units):
                    unit()
                torch.cuda.synchronize()
            expected = (launched() - before) if launched else None
        split = tr.device_split(prof, labels, calls=calls, window_t0=t0)
        if not split:
            continue
        split["units"] = units
        split["expected"] = expected
        split["calls"] = {label: sum(1 for lb, a, _ in calls
                                     if lb == label and a >= t0)
                          for label in labels}
        seen = sum(split["launches"].values())
        if expected is None or seen >= expected:
            break
    print(f"trace: {units} units, busy {split.get('busy_s')} s of "
          f"{split.get('window_s')} s, by label {split.get('labels')}, "
          f"calls {split.get('calls')}, launches seen "
          f"{split.get('launches')} of {split.get('expected')}",
          file=sys.stderr, flush=True)
    return split


def release(torch: Any) -> None:
    """Free what the program left on the card before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
