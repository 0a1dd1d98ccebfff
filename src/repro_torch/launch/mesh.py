"""Production mesh definitions: the counterpart of
``repro/launch/mesh.py``.

``make_production_mesh`` is a function, so importing this module touches
no process group: one pod is (16, 16) = 256 devices over ('data',
'model'), two pods (2, 16, 16) = 512 over ('pod', 'data', 'model').
``make_test_mesh`` is the small (data, model) mesh of the multi-process
tests. Each is a ``DeviceMesh`` over the processes of the default process
group, on its device type (the card under NCCL or the host-staged gloo
backend, the host under gloo), so the group must be made first, of as
many processes as the mesh has devices. The reference's roofline
constants, a TPU's, are not carried over.
"""
from __future__ import annotations

from typing import Any


def _device_type() -> str:
    import torch.distributed as dist

    from repro_torch.parallel.sharding import HOST_STAGED

    if not dist.is_initialized():
        raise ValueError("a mesh spans the processes of torch.distributed's "
                         "default group; make it first")
    return "cuda" if dist.get_backend() in ("nccl", HOST_STAGED) else "cpu"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Any:
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> Any:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2) -> Any:
    """Small mesh for the multi-process tests."""
    return _mesh((data, model), ("data", "model"))
