"""The program's span log, as the readers of ``program_span`` metrics
take it when the record does not carry it: every micro-batch the run's
process committed, through ``repro_torch.data.metrics.recent_batches``.
A program without that function gives nothing."""
from __future__ import annotations


def batches() -> list[dict]:
    """The run's micro-batches, oldest first, each with its ``traced`` flag
    and its ``spans``; empty where the program keeps no span log."""
    try:
        from repro_torch.data.metrics import recent_batches
    except ImportError:
        return []
    return recent_batches()


def window(rec: dict, all_batches: list[dict]) -> list[dict]:
    """The window's batches: the last ``rec["window_units"]`` recorded with
    tracing off before the trace's first traced batch."""
    n = rec.get("window_units") or 0
    first = next((i for i, b in enumerate(all_batches) if b.get("traced")),
                 len(all_batches))
    untraced = [b for b in all_batches[:first] if not b.get("traced")]
    return untraced[-n:] if n > 0 else []


def traced(rec: dict, all_batches: list[dict]) -> list[dict]:
    """The traced batches: the last ``rec["trace"]["units"]`` recorded
    with tracing on."""
    n = (rec.get("trace") or {}).get("units") or 0
    return [b for b in all_batches if b.get("traced")][-n:] if n > 0 else []


def named(batches_: list[dict], name: str) -> list[dict]:
    """The spans called ``name`` in ``batches_``."""
    return [s for b in batches_ for s in b.get("spans", ())
            if s["name"] == name]
