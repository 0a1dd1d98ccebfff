"""Parallel training over ``torch.distributed``: logical-axis sharding
over a ``DeviceMesh`` (``sharding.py``) and the explicit-collective
data-parallel trainer (``dp.py``). The reference's pipeline schedule
(``pp.py``) and all-to-all MoE come later (ROADMAP Queue 1 items 9c,
9d).

The trainer's names are imported on first use: ``dp.py`` builds on the
optimizer, which reads the mesh layer of this package."""
from typing import Any

_DP = ("build_dp_train_step", "flatten_params", "init_dp_opt_state",
       "shard_batch", "unflatten_params")

__all__ = list(_DP)


def __getattr__(name: str) -> Any:
    if name in _DP:
        from repro_torch.parallel import dp
        return getattr(dp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
