"""Seconds from the start of the run's process to the start of its
measured window: imports, the card, the kernel library from its build
cache, the inputs and weights, the program's set-up and the warm-up of
the cell's own shapes."""


def read(rec: dict) -> float | None:
    return rec.get("setup_s")
