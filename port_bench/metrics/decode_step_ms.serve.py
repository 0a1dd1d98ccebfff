"""Host wall milliseconds a decode step (``transformer.decode_step`` and
the greedy pick, the batch's tokens on the host at the end): every decode
of the window over its steps."""


def read(rec: dict) -> float | None:
    if not rec.get("decode_steps"):
        return None
    return 1e3 * sum(rec["decode_s"]) / rec["decode_steps"]
