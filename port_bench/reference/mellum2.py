"""Plain fp32 reference of Mellum2-12B-A2.5B's forward pass, with its own
weight draw from the seed.

It reads the published config's own keys (``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``layer_types``, ``sliding_window``, ``rope_parameters``, ``num_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``, ``norm_topk_prob``,
``rms_norm_eps``, ``vocab_size``), as ``port_bench/configs/
mellum2-12b-a2.5b.json`` copies them. A layer ``i`` of kind
``layer_types[i]``:

* ``h = RMSNorm(x)·w1``; ``q, k, v = h·Wq, h·Wk, h·Wv`` split into heads;
* RoPE of the layer's kind on q and k (split halves): a sliding layer's
  default RoPE at its θ; a full layer's yarn, transformers'
  ``_compute_yarn_parameters`` written out (``yarn``): the default
  frequencies and those over ``factor``, blended by a linear ramp between
  the dimensions at which ``original_max_position_embeddings`` turns
  ``beta_fast`` and ``beta_slow`` times, cos and sin times
  ``attention_factor``;
* causal softmax attention scaled by 1/sqrt(hd), K and V shared by each
  group of query heads, a sliding layer's query at p seeing the keys
  p − window < j ≤ p; ``x += o·Wo``;
* ``h = RMSNorm(x)·w2``; the router's softmax over the experts, the top
  ``k``, their gates renormalised (``norm_topk_prob``); ``x += Σ g_e ·
  (silu(h·Wg_e) * (h·Wu_e))·Wd_e`` over the k chosen experts, computed
  expert by expert over the tokens that chose it, nothing dropped;

then the final RMSNorm and the untied head. RMSNorm's epsilon is the
config's. Every product runs in full fp32 (TF32 off, set by the caller).
The attention runs a sequence and ``QUERY_CHUNK`` queries at a time over
the keys they can see, and the layers one at a time, each drawn when its
turn comes (``draw_part``), so the fp32 model (48.6 GB) never lies on the
card whole. ``decoder.Matmul(fp8=True)`` is the control, as in
``reference/decoder.py``: every product's operands and every activation
the configuration keeps in bf16 rounded to fp8 e4m3.

Departures from the published model, each deliberate: no QK-norm (the
config has no key for one); no multi-token-prediction head (``described_as``
names one, the config defines none, and serving does not use it); random
weights drawn from the seed, not the checkpoint. Nothing here imports
the program.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference.decoder import Matmul, rmsnorm

QUERY_CHUNK = 1024


# -- the weights ---------------------------------------------------------------
def layer_specs(c: dict, i: int) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, std) of layer ``i``'s leaves in draw order; std 0 for
    a norm's scale, which is ones. The deviations are the dense decoder's
    (``reference/weights.py``): 1/sqrt(fan-in), the output projections'
    also over sqrt(2·layers)."""
    d, hd = c["hidden_size"], c["head_dim"]
    h, kh = c["num_attention_heads"], c["num_key_value_heads"]
    e, f, L = c["num_experts"], c["moe_intermediate_size"], \
        c["num_hidden_layers"]
    s_in = 1.0 / math.sqrt(d)
    p = f"layers.{i}."
    return [(p + "attn.wq", (d, h * hd), s_in),
            (p + "attn.wk", (d, kh * hd), s_in),
            (p + "attn.wv", (d, kh * hd), s_in),
            (p + "attn.wo", (h * hd, d),
             1.0 / math.sqrt(h * hd) / math.sqrt(2.0 * L)),
            (p + "moe.router", (d, e), s_in),
            (p + "moe.w_gate", (e, d, f), s_in),
            (p + "moe.w_up", (e, d, f), s_in),
            (p + "moe.w_down", (e, f, d),
             1.0 / math.sqrt(f) / math.sqrt(2.0 * L)),
            (p + "norm1.scale", (d,), 0.0),
            (p + "norm2.scale", (d,), 0.0)]


def head_specs(c: dict) -> list[tuple[str, tuple[int, ...], float]]:
    d, V = c["hidden_size"], c["vocab_size"]
    s_in = 1.0 / math.sqrt(d)
    return [("embed.tok", (V, d), s_in), ("embed.lm_head", (d, V), s_in),
            ("final_norm.scale", (d,), 0.0)]


def draw_part(c: dict, seed: int, part: int | str, device
              ) -> dict[str, torch.Tensor]:
    """One part's leaves in bf16 on ``device``: layer ``part`` or, for
    ``"head"``, the embeddings, the head and the final norm. Each part
    draws from its own generator, seeded from (seed, part), every matrix a
    view of one ``torch.randn`` buffer scaled by its deviation, so a part
    drawn alone equals the same part drawn with the rest."""
    specs = head_specs(c) if part == "head" else layer_specs(c, part)
    index = 0 if part == "head" else int(part) + 1
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1024 + index) % (2 ** 63))
    total = sum(math.prod(shape) for _, shape, std in specs if std)
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


def draw(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf in bf16: the head's part and each layer's."""
    out = draw_part(c, seed, "head", device)
    for i in range(c["num_hidden_layers"]):
        out.update(draw_part(c, seed, i, device))
    return out


def fp32_parts(c: dict, seed: int, device):
    """``get(part)``: a part's leaves in fp32, drawn when asked."""
    def get(part):
        return {n: t.float() for n, t in
                draw_part(c, seed, part, device).items()}
    return get


def parts_of(w: dict[str, torch.Tensor]):
    """``get(part)`` over leaves already drawn (bf16 or fp32), in fp32."""
    def get(part):
        prefix = "layers." if part == "head" else f"layers.{part}."
        if part == "head":
            return {n: t.float() for n, t in w.items()
                    if not n.startswith(prefix)}
        return {n: t.float() for n, t in w.items() if n.startswith(prefix)}
    return get


# -- RoPE ----------------------------------------------------------------------
def yarn(head_dim: int, p: dict, device=None) -> tuple[torch.Tensor, float]:
    """transformers' ``_compute_yarn_parameters`` (``truncate`` on) for the
    parameters ``p`` (``rope_theta``, ``factor``,
    ``original_max_position_embeddings``, ``beta_fast``, ``beta_slow``,
    ``attention_factor``): the inverse frequencies and the cos/sin
    scale."""
    base, factor = p["rope_theta"], p["factor"]
    pos = base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                device=device) / head_dim)

    def corr(rot):
        return (head_dim * math.log(p["original_max_position_embeddings"]
                                    / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(p["beta_fast"])), 0)
    high = min(math.ceil(corr(p["beta_slow"])), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    extra = 1 - ramp
    inv = 1.0 / (factor * pos) * (1 - extra) + 1.0 / pos * extra
    return inv, float(p["attention_factor"])


def rope(x: torch.Tensor, start: int, p: dict) -> torch.Tensor:
    """x (S, H, hd) at positions start..start+S-1, RoPE of parameters
    ``p`` (``rope_type`` default or yarn)."""
    S, hd = x.shape[0], x.shape[-1]
    if p.get("rope_type", "default") == "yarn":
        inv, scale = yarn(hd, p, x.device)
    else:
        inv = 1.0 / p["rope_theta"] ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        scale = 1.0
    ang = torch.arange(start, start + S, dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# -- the layer -----------------------------------------------------------------
def attention(q, k, v, window: int, mm: Matmul) -> torch.Tensor:
    """One sequence: q (S, H, hd), k and v (S, KH, hd) -> (S, H·hd); causal,
    and with ``window`` > 0 each query at p sees p − window < j ≤ p;
    ``QUERY_CHUNK`` queries at a time over the keys they can see."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    out = []
    for a in range(0, S, QUERY_CHUNK):
        b = min(a + QUERY_CHUNK, S)
        k0 = max(0, a - window + 1) if window > 0 else 0
        kk = k[k0:b].repeat_interleave(g, dim=1).transpose(0, 1)
        vv = v[k0:b].repeat_interleave(g, dim=1).transpose(0, 1)
        s = mm(q[a:b].transpose(0, 1), kk.transpose(1, 2)) / math.sqrt(hd)
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(k0, b, device=q.device)[None, :]
        hide = kp > qp
        if window > 0:
            hide = hide | (qp - kp >= window)
        p = torch.softmax(s.masked_fill(hide, float("-inf")), dim=-1)
        out.append(mm(p, vv).transpose(0, 1).reshape(b - a, H * hd))
    return torch.cat(out)


def experts(a: torch.Tensor, w: dict, p: str, c: dict, mm: Matmul
            ) -> torch.Tensor:
    """The routed experts' sum for tokens a (T, D), expert by expert."""
    act = mm.act
    E, k = c["num_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(mm(a, w[p + "moe.router"]), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if c.get("norm_topk_prob", True):
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(a)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = a[tok]
        h = act(act(torch.nn.functional.silu(
            act(mm(rows, w[p + "moe.w_gate"][e]))))
            * act(mm(rows, w[p + "moe.w_up"][e])))
        y = act(mm(h, w[p + "moe.w_down"][e]))
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return act(out)


def layer(x: torch.Tensor, w: dict, i: int, c: dict, mm: Matmul
          ) -> torch.Tensor:
    """Layer ``i`` over x (N, S, D), a sequence at a time through the
    attention."""
    p = f"layers.{i}."
    N, S, D = x.shape
    h, kh, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    kind = c["layer_types"][i]
    window = c["sliding_window"] if kind == "sliding_attention" else 0
    rp = c["rope_parameters"][kind]
    eps = c["rms_norm_eps"]
    act = mm.act
    a = act(rmsnorm(x, w[p + "norm1.scale"], eps))
    o = []
    for n in range(N):
        q = act(rope(mm(a[n], w[p + "attn.wq"]).view(S, h, hd), 0, rp))
        k = act(rope(mm(a[n], w[p + "attn.wk"]).view(S, kh, hd), 0, rp))
        v = act(mm(a[n], w[p + "attn.wv"]).view(S, kh, hd))
        o.append(act(attention(q, k, v, window, mm)))
    x = act(x + act(mm(torch.stack(o), w[p + "attn.wo"])))
    a = act(rmsnorm(x, w[p + "norm2.scale"], eps))
    return act(x + experts(a.reshape(N * S, D), w, p, c, mm).view(N, S, D))


def logits_at(get, tokens: torch.Tensor, start: int, c: dict, mm: Matmul
              ) -> torch.Tensor:
    """Logits (N, S - start, V) at positions start..S-1 of ``tokens`` (N,
    S); ``get(part)`` gives a part's fp32 leaves (``fp32_parts``,
    ``parts_of``), taken a layer at a time."""
    with torch.no_grad():
        x = mm.act(get("head")["embed.tok"][tokens])
        for i in range(c["num_hidden_layers"]):
            x = layer(x, get(i), i, c, mm)
        head = get("head")
        x = mm.act(rmsnorm(x[:, start:], head["final_norm.scale"],
                           c["rms_norm_eps"]))
        return mm(x, head["embed.lm_head"])
