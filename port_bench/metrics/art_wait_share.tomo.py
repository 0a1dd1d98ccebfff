"""The §IV partitions' wait behind each other on the card's one stream:
one minus the ART calls' device time (each ``art`` span's CUDA event
pair) over the scheduler tasks' wall time (each ``task`` span, from an
executor's pick-up to the sub-volume on the host), both summed over the
window's batches (``rec["spans"]``, recorded with tracing off). None
where the batches carry no such spans."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    spans = [s for b in rec.get("spans") or () for s in b.get("spans", ())]
    tasks = sum(s["end"] - s["start"] for s in spans if s["name"] == "task")
    art = [s["device_s"] for s in spans if s["name"] == "art"]
    if not tasks or not art or None in art:
        return None
    return ys.share(tasks - sum(art), tasks)
