"""The ART kernel's share of its roofline: the least time the bytes of the
traced batches' ART calls need (``yardstick.art_bytes``: the CSR once a
sweep, the sinogram rows, the volume in and out; memory-bound) over the
device time of the kernels launched inside ``art_ops.art_reconstruct``."""
from port_bench import yardstick as ys


def read(rec: dict) -> float | None:
    tr = rec.get("trace") or {}
    device_s = tr.get("labels", {}).get("art", 0.0)
    if not device_s:
        return None
    calls = tr["units"] * rec["partitions"]
    nbytes = calls * ys.art_bytes(rec["art_nnz"], rec["nrow"], rec["ncol"],
                                  rec["partition_slices"], rec["sweeps"])
    flops = calls * ys.art_flops(rec["art_nnz"], rec["partition_slices"],
                                 rec["sweeps"])
    return ys.share(ys.roofline_seconds(flops, nbytes, ys.PEAK_FP32_FLOPS),
                    device_s)
