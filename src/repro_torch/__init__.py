"""PyTorch + CUDA port of the Spark-MPI near-real-time pipelines.

The JAX package ``repro`` is the reference; this package is its
counterpart for an NVIDIA Hopper GPU and keeps its module paths and names.
It imports ``torch``, numpy and scipy, and nothing of ``jax`` or ``repro``.
Its paths are the paper's §III streaming ptychography loop
(``python -m repro_torch.apps.ptycho.stream``), whose three elementwise
hot spots run as hand-written CUDA kernels (``repro_torch/csrc``), and its
§IV streaming tomography (``python -m repro_torch.apps.tomo.stream``),
whose ART sweep is a hand-written CUDA kernel too, and the language-model
serving loop (``python -m repro_torch.launch.serve``), whose prefill runs
causal attention in a hand-written CUDA flash kernel. The remote-ingest
topology (``python -m repro_torch.apps.ptycho.remote_ingest``) puts the
detector in a process of its own, joined to the consumer on the card by
the socket transport, and the HA topology (``python -m
repro_torch.apps.ptycho.ha_failover``) keeps that consumer fed through a
SIGKILL of the broker's primary. The compute plane (``core.pmi``,
``core.bridge``, ``core.fault``, ``optim``, ``checkpoint``) runs the
paper's Spark-MPI bridge on ``torch.distributed``
(``python -m repro_torch.apps.quickstart``), the §III stream's
``--elastic`` worker set, and checkpoint/restart on the reference's
on-disk layout.
"""
