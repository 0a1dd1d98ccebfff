"""The blocked attention's device time (``attention.blocked_attention``:
its forward, its recompute and the backward nodes of its operations) over
the traced steps' device busy time."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    t = tr.get("labels", {}).get("attention", 0.0)
    if not t:
        return None
    return ys.share(t, tr["busy_s"])
