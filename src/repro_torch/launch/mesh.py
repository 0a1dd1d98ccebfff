"""Production mesh definitions and the card's roofline constants: the
counterpart of ``repro/launch/mesh.py``.

``make_production_mesh`` is a function, so importing this module touches
no process group: one pod is (16, 16) = 256 devices over ('data',
'model'), two pods (2, 16, 16) = 512 over ('pod', 'data', 'model').
``make_test_mesh`` is the small (data, model) mesh of the multi-process
tests. Each is a ``DeviceMesh`` over the processes of the default process
group, so the group must be made first, of as many processes as the mesh
has devices. Its device type is ``device_type`` where the caller names
one (the dry-run builds a 'cuda' mesh over a fake group), else the
group's: the card under NCCL or the host-staged gloo backend, the host
under gloo or the fake backend.

The constants below are an NVIDIA H100 SXM's, the card the port runs on,
where the reference keeps a TPU v5e's; the dry-run's roofline
(``launch/dryrun.py``) divides a rank's counted work by them. Ranks fill
nodes in order, ``GPUS_PER_NODE`` a node, so rank r sits on node
r // 8: a group inside one node talks over NVLink, a group across nodes
over the network. On the production meshes a 'model' group (16
consecutive ranks, 'model' being the last, fastest axis) spans two nodes
and a 'data' group (every 16th rank) sixteen.
"""
from __future__ import annotations

from typing import Any

# NVIDIA H100 SXM5 data sheet, at its 700 W limit: dense bf16 tensor-core
# rate and the HBM3 rate
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# fourth-generation NVLink: 900 GB/s a card, 450 GB/s each way
NVLINK_BW = 450e9
GPUS_PER_NODE = 8           # an HGX/DGX H100 node
# ASSUMED: across nodes one 400 Gb/s NDR InfiniBand link a card, as on a
# DGX H100 (8 ConnectX-7 ports a node), 50 GB/s each way; no cluster was
# measured, as the reference assumes its DCN_BW
NETWORK_BW = 50e9


def _device_type() -> str:
    import torch.distributed as dist

    from repro_torch.parallel.sharding import HOST_STAGED

    if not dist.is_initialized():
        raise ValueError("a mesh spans the processes of torch.distributed's "
                         "default group; make it first")
    return "cuda" if dist.get_backend() in ("nccl", HOST_STAGED) else "cpu"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str | None) -> Any:
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type()
    return init_device_mesh(device_type or kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> Any:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2,
                   device_type: str | None = None) -> Any:
    """Small mesh for the multi-process tests."""
    return _mesh((data, model), ("data", "model"), device_type)
