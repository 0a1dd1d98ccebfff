"""The Spark layer's own time over the window's seconds: the batch spans'
time outside ``batch_fn`` and ``sinks`` (the source pump, the RDD's
assembly, the commits)."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    spans = rec.get("spans")
    if not spans:
        return None
    host = sum(s["total_s"] + s["stages"].get("pump", 0.0)
               - s["stages"].get("batch_fn", 0.0)
               - s["stages"].get("sinks", 0.0) for s in spans)
    return ys.share(host, rec["window_s"])
