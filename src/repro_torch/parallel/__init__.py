"""Parallel training over ``torch.distributed`` process groups: the
explicit-collective data-parallel trainer (``dp.py``). The reference's
mesh (``sharding.py``), pipeline schedule (``pp.py``) and the GSPMD specs
come with the port's mesh (ROADMAP Queue 1 item 9)."""
from repro_torch.parallel.dp import (build_dp_train_step, flatten_params,
                                     init_dp_opt_state, shard_batch,
                                     unflatten_params)

__all__ = ["build_dp_train_step", "flatten_params", "init_dp_opt_state",
           "shard_batch", "unflatten_params"]
