"""Checkpoints of the port: atomic, async, elastic restore, on the
reference's on-disk layout."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore, save)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
