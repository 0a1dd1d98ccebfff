"""The card's idle time inside the AdamW update, ms a step: the
``optimizer`` span's device time a step (its CUDA event pair, from the
update's first work on the stream to its last; the window's steps,
recorded with tracing off, from the program's span log) less the device
time of the update's own kernels a traced step (the ``adamw`` label over
the traced units). None where the program keeps no span log."""
from port_bench import spanlog


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    adamw = tr.get("labels", {}).get("adamw", 0.0)
    if not adamw or not tr.get("units") or not rec.get("window_units"):
        return None
    spans = spanlog.named(spanlog.window(rec, spanlog.batches()),
                          "optimizer")
    device = [s["device_s"] for s in spans]
    if not device or None in device:
        return None
    return 1e3 * (sum(device) / len(device) - adamw / tr["units"])
