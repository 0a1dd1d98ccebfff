"""The MoE layers' share of the traced batches' time on the card's clock:
the ``moe_route``, ``moe_dispatch``, ``moe_experts`` and ``moe_combine``
spans' CUDA event pairs (fine spans recorded while the profiler records)
summed, over the traced window's wall time. An event pair holds the
device's idle gaps between its two events too, so the share is of the
window and not of the device's busy time, which those gaps could
outgrow. None where the program keeps no such spans."""
from port_bench import spanlog
from port_bench import yardstick as ys

NAMES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    if not tr.get("units") or not tr.get("window_s"):
        return None
    traced = spanlog.traced(rec, spanlog.batches())
    device = [s["device_s"] for n in NAMES
              for s in spanlog.named(traced, n)]
    if not device or None in device:
        return None
    return ys.share(sum(device), tr["window_s"])
