"""The AdamW update's device milliseconds a step (``training.adamw_update``,
``optim/adamw.py``), over the traced steps."""


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    t = tr.get("labels", {}).get("adamw", 0.0)
    if not t:
        return None
    return 1e3 * t / tr["units"]
