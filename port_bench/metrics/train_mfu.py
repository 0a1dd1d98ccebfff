"""The window's model FLOPs (``yardstick.model_flops_train`` a step, the
dry-run's 6·N·D and causal-attention formula, frozen) over the window's
seconds and the card's bf16 peak, 989 TFLOP/s at 700 W."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    if "steps" not in rec or "model" not in rec:
        return None
    flops = rec["steps"] * ys.model_flops_train(rec["model"], rec["batch"],
                                                rec["seq"])
    return ys.share(flops / rec["window_s"], ys.PEAK_BF16_FLOPS)
