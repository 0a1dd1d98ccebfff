"""The device's idle share of the window: one minus the device's busy time
a unit (a batch or a step), the union of its intervals over the traced
units, over the wall time a unit of the untraced window. The profiler's
own host cost lengthens a traced unit's wall time but not its device
work, so the wall is the untraced window's."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    if not tr.get("units") or not rec.get("window_units"):
        return None
    busy = tr["busy_s"] / tr["units"]
    wall = rec["window_s"] / rec["window_units"]
    return ys.share(wall - busy, wall)
