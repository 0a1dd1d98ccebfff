"""Parallel training over ``torch.distributed``: logical-axis sharding
over a ``DeviceMesh`` (``sharding.py``), the explicit-collective
data-parallel trainer (``dp.py``) and the GPipe pipeline over the 'pod'
axis (``pp.py``).

The trainer's and the pipeline's names are imported on first use:
``dp.py`` builds on the optimizer, which reads the mesh layer of this
package."""
from typing import Any

_DP = ("build_dp_train_step", "flatten_params", "init_dp_opt_state",
       "shard_batch", "unflatten_params")
_PP = ("gpipe_apply", "pipeline_layers")

__all__ = list(_DP + _PP)


def __getattr__(name: str) -> Any:
    if name in _DP:
        from repro_torch.parallel import dp
        return getattr(dp, name)
    if name in _PP:
        from repro_torch.parallel import pp
        return getattr(pp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
