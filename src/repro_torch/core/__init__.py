"""The core of the port: the broker, RDDs, micro-batch streams, the
pipeline that composes them, and the compute plane: the PMI wire-up, the
Spark<->MPI bridge on ``torch.distributed`` and its fault tolerance.
Copies of ``repro.core``'s modules (``TorchBridge`` stands where the
reference has ``MPIBridge``).

The package exports the reference's names. They resolve on first use, as
``repro_torch.data``'s do: the broker imports the data package, whose
modules import the broker.
"""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "bridge": ("TorchBridge", "make_worker_mesh", "rank_of", "world_of"),
    "broker": ("Broker", "InMemoryPartitionLog", "OffsetRange",
               "PartitionLog", "Record", "create_rdd"),
    "dstream": ("BatchInfo", "StreamingContext", "StreamProgress"),
    "fault": ("ElasticController", "ElasticEvent", "LagPolicy", "Watchdog",
              "WorkerFailure", "run_with_recovery"),
    "pipeline": ("NearRealTimePipeline", "PipelineConfig", "PipelineReport"),
    "pmi": ("KeyValueSpace", "PMIClient", "PMIError", "PMIServer"),
    "rdd": ("RDD", "Context", "FailureInjector", "PartitionLostError",
            "TaskScheduler"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items()
              for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str) -> Any:
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value             # later lookups skip this function
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
