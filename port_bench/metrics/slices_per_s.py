"""Slices whose sub-volumes were committed to the sink in the window, over
the window's seconds."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    if "slices" not in rec:
        return None
    return ys.rate(rec["slices"], rec["window_s"])
