"""Launch wrapper of the three CUDA flash-attention kernels, the
counterparts of ``repro/kernels/flash_attention/kernel.py:
flash_attention_bhsd``: ``csrc/flash_attention_wgmma.cu`` (``wgmma`` on
Hopper's tensor cores) takes every bf16 call at head dims 64, 128 and 256,
the models' prefill; ``csrc/flash_attention_tf32x3.cu`` (split TF32 on
``mma.sync``, as close to float64 as fp32 FMAs) takes every fp32 call; and
``csrc/flash_attention.cu`` (fp32 FMAs) bf16 at the small head dims. Any
other head dim is refused: no kernel is built at it.

The launch is registered as the PyTorch operator
``repro_torch::flash_attention`` (CUDA only) with a fake implementation
and a FLOP formula, so that the dry-run (``launch/dryrun.py``) traces a
prefill through it on fake tensors and counts its products. Registering
builds nothing: the library is built at the first launch."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the kernels' instantiations
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
DESIGNS = ("wgmma", "tf32x3", "simt")


def design_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes a call: "tf32x3" for every fp32 call, "wgmma"
    for bf16 at hd 64, 128 and 256, "simt" for bf16 at the small head dims.
    Raises ``ValueError`` for a head dim no kernel is built at."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not built; the "
                         f"kernels take {HEAD_DIMS}")
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) in the model layout (K/V repeated to H), all
    fp32 or all bf16, contiguous on one CUDA device, hd in ``HEAD_DIMS``.
    Returns the causal attention (key ``t`` visible to query ``s`` iff
    ``t <= s``) in the same layout and type. The (B*H, S, hd) layout of the
    reference kernel is the case H = 1. The launch is the operator
    ``repro_torch::flash_attention``, so a dispatch mode sees it, a fake
    tensor passes through it by its shape, and ``FlopCounterMode`` counts
    it by ``flash_flops``."""
    op = "flash_attention"
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError(f"{op}: q must be a (B, S, H, hd) tensor")
    _build.check_tensor(op, "q", q, q.dtype, q.shape)
    if q.dtype not in _DTYPES:
        raise TypeError(f"{op}: q must be float32 or bfloat16, got {q.dtype}")
    _build.check_tensor(op, "k", k, q.dtype, q.shape, q.device)
    _build.check_tensor(op, "v", v, q.dtype, q.shape, q.device)
    design_for(q.dtype, q.shape[3])
    return torch.ops.repro_torch.flash_attention(q, k, v)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel that
    ``design_for`` picks, counted on ``flash_attention``."""
    B, S, H, hd = q.shape
    design = design_for(q.dtype, hd)
    o = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = _build.current_stream(q.device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if design == "wgmma":
            rc = lib.flash_attention_wgmma_launch(*ptrs, B, S, H, hd, stream)
        elif design == "tf32x3":
            rc = lib.flash_attention_tf32x3_launch(*ptrs, B, S, H, hd, stream)
        else:
            rc = lib.flash_attention_launch(*ptrs, B, S, H, hd, stream)
    _build.check_launch(f"flash_attention ({design})", rc)
    with _build.COUNT_LOCK:
        flash_attention.launches += 1
        flash_attention.launches_by_design[design] += 1
        flash_attention.launches_by_instance[design, hd] += 1
    return o


@_launch.register_fake
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(q)


def flash_flops(B: int, S: int, H: int, hd: int) -> int:
    """The products of one causal call, the count the kernel table's bound
    uses: Q·K^T and P·V over the S(S+1)/2 visible pairs of each of the
    B·H heads, 2·hd operations a pair each."""
    return 4 * B * H * hd * S * (S + 1) // 2


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flop_formula(q_shape, k_shape, v_shape, *args, out_shape=None,
                  **kwargs) -> int:
    return flash_flops(*q_shape)


# every built (design, head dim) pair, each a template instance
INSTANCES = tuple(sorted({(design_for(dtype, hd), hd) for dtype in _DTYPES
                          for hd in HEAD_DIMS}))
flash_attention.launches = 0
flash_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_attention.launches_by_instance = dict.fromkeys(INSTANCES, 0)
