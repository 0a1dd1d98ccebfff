"""The batch spans' ``sinks`` stage (the npz writes and the metrics sink,
serial before each commit) over the window's seconds."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    spans = rec.get("spans")
    if not spans:
        return None
    return ys.share(sum(s["stages"].get("sinks", 0.0) for s in spans),
                    rec["window_s"])
