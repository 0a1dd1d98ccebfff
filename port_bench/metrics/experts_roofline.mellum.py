"""The routed experts' products against their compute roofline in the
traced batches: every token-slot's SwiGLU products, 6·D·F FLOP a slot
(gate, up and down), at the bf16 peak, over the device time of the
``moe_experts`` spans (their CUDA event pairs). The slots are counted
here from the traffic, not read from the program: each of a batch's
B·P prefill tokens and B·(G − 1) decoded ones takes k slots in each of
the L layers, so the count is the same whatever computes the products.
A decode step's products are bound by the experts' weights, not their
FLOP; counted at their FLOP bound, they lower the share and never raise
it. None where the program keeps no such spans."""
from port_bench import spanlog
from port_bench import yardstick as ys


def expert_flops(m: dict, tokens: int) -> float:
    """6·D·F a slot, k slots a token in each of the L layers."""
    return (6.0 * m["d_model"] * m["d_ff"] * m["experts_per_token"]
            * m["num_layers"] * tokens)


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    units = tr.get("units")
    if not units or "model" not in rec:
        return None
    traced = spanlog.traced(rec, spanlog.batches())
    device = [s["device_s"] for s in spanlog.named(traced, "moe_experts")]
    if not device or None in device:
        return None
    B, P, G = rec["batch"], rec["prompt_len"], rec["gen"]
    flops = units * expert_flops(rec["model"], B * P + B * (G - 1))
    return ys.share(flops / ys.PEAK_BF16_FLOPS, sum(device))
