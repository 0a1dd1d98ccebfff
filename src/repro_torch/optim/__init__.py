"""The optimizer substrate of the port: gradient compression with error
feedback (the reference's AdamW and ZeRO-1 are not ported)."""
from repro_torch.optim.compression import (compressed_psum, compressed_sum,
                                           dequantize_int8, ef_compress_tree,
                                           init_residual, quantize_int8)

__all__ = ["compressed_psum", "compressed_sum", "dequantize_int8",
           "ef_compress_tree", "init_residual", "quantize_int8"]
