"""Plain PyTorch version of causal attention (the kernel's oracle), the same
function as ``repro/kernels/flash_attention/ref.py:attention_ref``."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Skv, hd), fp32 or bf16 -> (BH, Sq, hd).
    Scores and softmax in fp32. The causal mask is the reference's
    bottom-right ``tril(k=Skv - Sq)``; the kernel's is top-left
    (``kpos <= qpos``), and the two agree at Sq = Skv, the only case the
    model calls."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
