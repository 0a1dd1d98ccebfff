"""Dispatch for causal attention in the model layout: the CUDA kernel for a
CUDA tensor, the plain PyTorch version for a CPU tensor. A kernel that fails
to build or launch raises; nothing falls back to the plain version.

The kernel has no backward pass, as the reference's Pallas kernel has none
(the reference trains on its ``blocked`` schedule, never the kernel): its
output is written through raw pointers and carries no ``grad_fn``. So a
call that asks for the kernel while autograd records and q, k or v
requires grad is refused before dispatch, rather than returning an output
that would silently drop the attention's gradient."""
from __future__ import annotations

import torch

from repro_torch.data.metrics import fine_span
from repro_torch.kernels.flash_attention import kernel, ref

NO_BACKWARD = (
    "flash_attention: the kernel has no backward pass (nor has the "
    "reference's Pallas kernel), so it is refused for inputs that require "
    "grad; train on the blocked schedule, as training.build_train_step "
    "does")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) with K/V repeated to H -> (B, S, H, hd),
    causal. The kernel reads this layout in place and masks the tail past
    S, where ``repro/kernels/flash_attention/ops.py`` transposes to
    (B*H, S, hd) and pads S to its blocks; rows < S are the same function.
    ``use_kernel=None`` means the kernel iff ``q`` is on CUDA; ``False``
    asks for the plain version on either device. Asking for the kernel
    while autograd records and q, k or v requires grad raises
    ``RuntimeError`` (``NO_BACKWARD``). The kernel's call is a fine span,
    ``flash_attention``."""
    if q.is_cuda if use_kernel is None else use_kernel:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(NO_BACKWARD)
        with fine_span("flash_attention"):
            return kernel.flash_attention(q, k, v)
    B, S, H, hd = q.shape

    def to_bhsd(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(B * H, x.shape[1], hd)

    out = ref.attention_ref(to_bhsd(q), to_bhsd(k), to_bhsd(v), causal=True)
    return out.reshape(B, H, S, hd).transpose(1, 2)
