"""Tokens generated for the requests completed in the window over the
window's seconds (padding rows not counted)."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    if "served_tokens" not in rec:
        return None
    return ys.rate(rec["served_tokens"], rec["window_s"])
