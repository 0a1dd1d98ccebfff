"""Launch wrapper of the CUDA flash-attention kernel
(csrc/flash_attention.cu), the counterpart of
``repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 128)           # the kernel's instantiations
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) in the model layout (K/V repeated to H), all
    fp32 or all bf16, contiguous on one CUDA device, hd in ``HEAD_DIMS``.
    Returns the causal attention (key ``t`` visible to query ``s`` iff
    ``t <= s``) in the same layout and type. The (B*H, S, hd) layout of the
    reference kernel is the case H = 1."""
    op = "flash_attention"
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError(f"{op}: q must be a (B, S, H, hd) tensor")
    _build.check_tensor(op, "q", q, q.dtype, q.shape)
    if q.dtype not in _TYPE_CODES:
        raise TypeError(f"{op}: q must be float32 or bfloat16, got {q.dtype}")
    _build.check_tensor(op, "k", k, q.dtype, q.shape, q.device)
    _build.check_tensor(op, "v", v, q.dtype, q.shape, q.device)
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{op}: head_dim {hd} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    o = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            hd, _TYPE_CODES[q.dtype], _build.current_stream(q.device))
    _build.check_launch(op, rc)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
