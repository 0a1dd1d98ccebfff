"""Plain fp32 reference of the dense decoder (internlm2's layer equations)
and of its training step.

A layer: ``h = RMSNorm(x)·w1``; ``q, k, v = h·Wq, h·Wk, h·Wv`` split into
heads, RoPE (split halves, θ from the config) on q and k, K and V repeated
to every query head, causal softmax attention scaled by 1/sqrt(hd), ``x +=
attn·Wo``; ``h = RMSNorm(x)·w2``; ``x += (silu(h·Wg) * (h·Wu))·Wd``. Then the
final RMSNorm and the untied head. RMSNorm's epsilon is 1e-6. The loss is
the mean next-token cross-entropy over every position but the last. The
step is AdamW with fp32 moments: linear warmup then cosine decay to 10 %,
the gradients clipped by their global norm, bias-corrected moments, decay
on every leaf ``weights.decays`` names.

Every product runs in full fp32 (TF32 off). ``Matmul(fp8=True)`` is the
control, one precision step below the bf16 the configuration serves and
trains in: both operands of every product, and every activation the
configuration keeps in bf16 (the embeddings, the residual stream, each
norm's, projection's, attention's and MLP's output), rounded to fp8 e4m3,
each tensor scaled by its largest magnitude; the backward pass's products
take the rounded operands and the gradients pass in fp32. Nothing here imports the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through fp8 e4m3, scaled so that its largest magnitude maps to
    the format's largest; the gradient passes through in fp32."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


@dataclass(frozen=True)
class Matmul:
    """The reference's products, and with ``fp8`` its activations kept in
    fp8 where the configuration keeps them in bf16."""
    fp8: bool = False

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return a @ b

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.fp8 else x


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm: Matmul) -> torch.Tensor:
    """Causal attention, one sequence at a time: q (B, S, H, hd), k and v
    (B, S, KH, hd) -> (B, S, H·hd)."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    rows = []
    for b in range(B):
        s = mm(q[b].transpose(0, 1), k[b].permute(1, 2, 0)) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
        rows.append(mm(p, v[b].transpose(0, 1)).transpose(0, 1)
                    .reshape(S, H * hd))
    return torch.stack(rows)


def layer(x: torch.Tensor, w: dict, i: int, m: dict, mm: Matmul
          ) -> torch.Tensor:
    p = f"layers.{i}."
    B, S, _ = x.shape
    h, kh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    act = mm.act
    a = act(rmsnorm(x, w[p + "norm1.scale"]))
    q = act(rope(mm(a, w[p + "attn.wq"]).view(B, S, h, hd), m["rope_theta"]))
    k = act(rope(mm(a, w[p + "attn.wk"]).view(B, S, kh, hd), m["rope_theta"]))
    v = act(mm(a, w[p + "attn.wv"]).view(B, S, kh, hd))
    x = act(x + act(mm(act(attention(q, k, v, mm)), w[p + "attn.wo"])))
    a = act(rmsnorm(x, w[p + "norm2.scale"]))
    gate = act(torch.nn.functional.silu(act(mm(a, w[p + "mlp.w_gate"]))))
    h = act(gate * act(mm(a, w[p + "mlp.w_up"])))
    return act(x + act(mm(h, w[p + "mlp.w_down"])))


def hidden(w: dict, tokens: torch.Tensor, m: dict, mm: Matmul,
           remat: bool = False) -> torch.Tensor:
    """The final normed hidden states (B, S, d)."""
    x = mm.act(w["embed.tok"][tokens])
    for i in range(m["num_layers"]):
        if remat:
            x = checkpoint(layer, x, w, i, m, mm, use_reentrant=False)
        else:
            x = layer(x, w, i, m, mm)
    return mm.act(rmsnorm(x, w["final_norm.scale"]))


def logits_at(w: dict, tokens: torch.Tensor, start: int, m: dict,
              mm: Matmul) -> torch.Tensor:
    """Logits (B, S - start, V) at positions start..S-1."""
    with torch.no_grad():
        return mm(hidden(w, tokens, m, mm)[:, start:], w["embed.lm_head"])


def loss(w: dict, tokens: torch.Tensor, m: dict, mm: Matmul,
         chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy, the head's logits a chunk of
    positions at a time."""
    x = hidden(w, tokens, m, mm, remat=True)[:, :-1]
    targets = tokens[:, 1:]

    def nll(xc, tc):
        z = mm(xc, w["embed.lm_head"])
        return (torch.logsumexp(z, -1)
                - z.gather(-1, tc[..., None])[..., 0]).sum()

    total = sum(checkpoint(nll, x[:, c:c + chunk], targets[:, c:c + chunk],
                           use_reentrant=False)
                for c in range(0, x.shape[1], chunk))
    return total / targets.numel()


def lr_at(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * t)))


def train(w0: dict, batches: list[torch.Tensor], m: dict, opt: dict,
          mm: Matmul, decays) -> dict:
    """AdamW steps from the bf16 weights ``w0`` in fp32, one a batch.
    Returns each step's loss, each leaf's clipped gradient norm at the
    first step and each leaf's change after the last."""
    params = {n: t.float().requires_grad_() for n, t in w0.items()}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    var = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first_grads = [], {}
    for step, tokens in enumerate(batches, start=1):
        value = loss(params, tokens, m, mm)
        grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads))
        scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
        lr = lr_at(step, opt)
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                g = g * scale
                if step == 1:
                    first_grads[n] = float(torch.linalg.vector_norm(g))
                mom[n].mul_(b1).add_(g, alpha=1 - b1)
                var[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                delta = (mom[n] / (1 - b1 ** step)) / (
                    torch.sqrt(var[n] / (1 - b2 ** step)) + eps)
                if opt["weight_decay"] > 0 and decays(n):
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
        del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - w0[n].float()))
                  for n, p in params.items()}
    return {"losses": losses, "grad_norms": first_grads, "changes": change}
