"""The window's prefills' model FLOPs (``yardstick.model_flops_prefill``,
the dry-run's prefill formula, frozen) over their wall time, each from the
batch's arrival in the batch function to its first tokens on the host,
and the card's bf16 peak."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    if not rec.get("prefill_s"):
        return None
    flops = len(rec["prefill_s"]) * ys.model_flops_prefill(
        rec["model"], rec["batch"], rec["prompt_len"])
    return ys.share(flops / sum(rec["prefill_s"]), ys.PEAK_BF16_FLOPS)
