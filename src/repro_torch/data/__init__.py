"""The port's data plane around the broker — copies of ``repro.data``'s
modules: sources and the ingest runner, payload codecs, sinks, lock
tracing, the socket transport (message codec, frames, ``BrokerServer``,
``RemoteBroker``), the durable log, the window-state store, windows, the
delivery lanes, consumer groups, broker replication with failover, and the
metrics registry with its batch spans and HTTP observability endpoint.

The package exports the reference's names. They resolve on first use: the
broker imports this package's lock tracing and metrics, and the transport,
groups and replication modules import the broker, so importing them all
here would close the cycle while the broker is half-initialised.
"""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "sources": ("Source", "ReplayableSource", "SequenceSource",
                "DetectorSource", "ProjectionSource", "FileReplaySource",
                "SyntheticRateSource", "TopicSource", "save_npz_capture"),
    "ingest": ("IngestConfig", "IngestRunner", "SourceMetrics",
               "ingest_all"),
    "window": ("WindowSpec", "WindowInfo", "Windower", "windowed"),
    "state": ("WindowState", "WindowStateStore", "InMemoryStateStore",
              "DurableStateStore"),
    "sinks": ("Sink", "KeyedSink", "NpzDirectorySink", "TopicSink",
              "MetricsSink", "CallbackSink", "describe_result_items",
              "fan_out"),
    "delivery": ("DeliveryRuntime", "SinkPolicy", "SinkLane", "LaneMetrics",
                 "DeliveryFailed", "SinkTimeoutError"),
    "transport": ("BrokerServer", "RemoteBroker", "serve_broker",
                  "parse_address", "TransportError", "FrameError"),
    "codec": ("Codec", "CodecBroker", "UnknownCodecError", "get_codec",
              "codec_names", "maybe_decode", "register_codec"),
    "groups": ("GroupCoordinator", "GroupMember", "GroupConsumer",
               "sticky_assign", "GroupError", "StaleGenerationError"),
    "durable_log": ("DurablePartitionLog", "DurableLogFactory",
                    "LogCorruptionError"),
    "replication": ("ReplicaFollower", "FailoverBroker"),
    "metrics": ("MetricsRegistry", "Counter", "Gauge", "Histogram",
                "NullRegistry", "get_registry", "set_registry", "disabled",
                "TraceLog", "BatchSpan", "SPAN_STAGES"),
    "obs_server": ("ObservabilityServer", "lag_health",
                   "serve_observability"),
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
