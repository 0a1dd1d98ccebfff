"""The sliding-window layers' attention in a prefill, device ms: the
``attention`` spans whose ``kind`` is ``sliding`` (each layer's norm,
projections, RoPE, attention core and cache write, by its CUDA event
pair) that ran inside a ``prefill`` span, summed over the traced batches
and divided by their prefills. None where the program keeps no such
spans."""
from port_bench import spanlog


def read(rec: dict) -> float | None:
    if not (rec.get("trace") or {}).get("units"):
        return None
    traced = spanlog.traced(rec, spanlog.batches())
    prefills = spanlog.named(traced, "prefill")
    inside = [s for s in spanlog.named(traced, "attention")
              if (s.get("attrs") or {}).get("kind") == "sliding"
              and any(p["thread"] == s["thread"]
                      and p["start"] <= s["start"] <= p["end"]
                      for p in prefills)]
    device = [s["device_s"] for s in inside]
    if not prefills or not device or None in device:
        return None
    return 1e3 * sum(device) / len(prefills)
