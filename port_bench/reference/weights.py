"""The dense decoder's weights, drawn from the seed by the benchmark.

One call of ``torch.randn`` on a generator on the device draws every
matrix at once in bf16, the type they are served in; each leaf is a view
of that buffer scaled by its standard deviation (the program's
initialisers' deviations: 1/sqrt(fan-in), the output projections' also
over sqrt(2·layers)); the norms' scales are ones. The program gets the
leaves, the reference draws them again from the same seed.
"""
from __future__ import annotations

import math

import torch


def leaf_specs(m: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, std) of every leaf in draw order; std 0 for a norm's
    scale, which is ones."""
    d, hd, h, kh = m["d_model"], m["head_dim"], m["num_heads"], \
        m["num_kv_heads"]
    f, V, L = m["d_ff"], m["vocab_size"], m["num_layers"]
    s_in = 1.0 / math.sqrt(d)
    s_o = 1.0 / math.sqrt(h * hd) / math.sqrt(2.0 * L)
    s_down = 1.0 / math.sqrt(f) / math.sqrt(2.0 * L)
    specs = [("embed.tok", (V, d), s_in), ("embed.lm_head", (d, V), s_in)]
    for i in range(L):
        p = f"layers.{i}."
        specs += [(p + "attn.wq", (d, h * hd), s_in),
                  (p + "attn.wk", (d, kh * hd), s_in),
                  (p + "attn.wv", (d, kh * hd), s_in),
                  (p + "attn.wo", (h * hd, d), s_o),
                  (p + "mlp.w_gate", (d, f), s_in),
                  (p + "mlp.w_up", (d, f), s_in),
                  (p + "mlp.w_down", (f, d), s_down),
                  (p + "norm1.scale", (d,), 0.0),
                  (p + "norm2.scale", (d,), 0.0)]
    return specs + [("final_norm.scale", (d,), 0.0)]


def draw(m: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """name -> bf16 leaf on ``device``, every matrix a view of one buffer."""
    specs = leaf_specs(m)
    total = sum(math.prod(shape) for _, shape, std in specs if std)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, at = {}, 0
    for name, shape, std in specs:
        if std:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        else:
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
    return out


def decays(name: str) -> bool:
    """Whether AdamW decays a leaf: every matrix and every layer's norm
    scale, which the configuration's optimizer stacks over the layers
    into a matrix; not the final norm's scale."""
    return name != "final_norm.scale"
