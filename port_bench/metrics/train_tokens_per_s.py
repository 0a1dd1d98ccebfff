"""Tokens of the train steps completed in the window over the window's
seconds; the window ends at the first step boundary at or after its
length, each step ending with its loss on the host."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    if "train_tokens" not in rec:
        return None
    return ys.rate(rec["train_tokens"], rec["window_s"])
