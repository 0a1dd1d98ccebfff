"""The flash kernel's share of its roofline in the traced batches: the
least time of its calls (``yardstick.flash_flops`` and ``flash_bytes``
at the prefill's shape, the larger of the bf16 FLOP bound and the byte
bound) over the device time of the kernels launched inside
``kernels.flash_attention.ops.flash_attention``. The calls are counted
at the labelled function, not by the kernels credited to it, so that a
second kernel the operator launches adds time and no call."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    device_s = tr.get("labels", {}).get("flash_attention", 0.0)
    calls = tr.get("calls", {}).get("flash_attention", 0)
    if not device_s or not calls:
        return None
    m = rec["model"]
    shape = (rec["batch"], m["num_heads"], rec["prompt_len"], m["head_dim"])
    least = ys.roofline_seconds(ys.flash_flops(*shape), ys.flash_bytes(*shape),
                                ys.PEAK_BF16_FLOPS)
    return ys.share(calls * least, device_s)
