"""The 95th percentile, over every request completed in the window, of the
time from the request's sending to its first token on the host."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    return ys.percentile(rec.get("ttft_s", []), 95)
