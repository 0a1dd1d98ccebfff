"""The decode's attention, device ms a decode step: the
``decode_attention`` spans' CUDA event pairs (each layer's cache-slot
write, its GQA-repeated cache and the attention core) summed over the
layers and the traced batches' decode steps (``decode`` spans), over
those steps. The spans are fine ones, recorded only while the profiler
records. None where the program keeps no span log."""
from port_bench import spanlog


def read(rec: dict) -> float | None:
    if not (rec.get("trace") or {}).get("units"):
        return None
    traced = spanlog.traced(rec, spanlog.batches())
    steps = len(spanlog.named(traced, "decode"))
    device = [s["device_s"] for s in spanlog.named(traced,
                                                   "decode_attention")]
    if not steps or not device or None in device:
        return None
    return 1e3 * sum(device) / steps
