"""The optimizer substrate of the port: AdamW with fp32 master weights,
its schedule and clipping, its ZeRO-1 state specs over a mesh, and
gradient compression with error feedback."""
from repro_torch.optim.adamw import (adamw_update, add_zero_axis,
                                     clip_by_global_norm, init_opt_state,
                                     lr_schedule, reference_ndim,
                                     zero1_state_specs)
from repro_torch.optim.compression import (compressed_psum, compressed_sum,
                                           dequantize_int8, ef_compress_tree,
                                           init_residual, quantize_int8)

__all__ = ["adamw_update", "add_zero_axis", "clip_by_global_norm",
           "init_opt_state", "lr_schedule", "reference_ndim",
           "zero1_state_specs", "compressed_psum",
           "compressed_sum", "dequantize_int8", "ef_compress_tree",
           "init_residual", "quantize_int8"]
