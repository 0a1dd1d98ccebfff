"""The optimizer substrate of the port: AdamW with fp32 master weights,
its schedule and clipping, and gradient compression with error feedback
(the reference's ZeRO-1 state specs come with the mesh)."""
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     init_opt_state, lr_schedule,
                                     reference_ndim)
from repro_torch.optim.compression import (compressed_psum, compressed_sum,
                                           dequantize_int8, ef_compress_tree,
                                           init_residual, quantize_int8)

__all__ = ["adamw_update", "clip_by_global_norm", "init_opt_state",
           "lr_schedule", "reference_ndim", "compressed_psum",
           "compressed_sum", "dequantize_int8", "ef_compress_tree",
           "init_residual", "quantize_int8"]
