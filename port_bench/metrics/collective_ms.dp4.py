"""The data-parallel step's collectives on rank 0, device ms a step: the
``dp_reduce_scatter`` and ``dp_all_gather`` spans' CUDA event pairs (each
collective and its wait for the slowest rank) summed over the window's
steps (``rec["spans"]``, rank 0's span log, recorded with tracing off)
and divided by them. None where the program keeps no such spans."""
from port_bench import spanlog

NAMES = ("dp_reduce_scatter", "dp_all_gather")


def read(rec: dict) -> float | None:
    steps = spanlog.window(rec, rec.get("spans") or [])
    device = [s["device_s"] for n in NAMES for s in spanlog.named(steps, n)]
    if not steps or not device or None in device:
        return None
    return 1e3 * sum(device) / len(steps)
