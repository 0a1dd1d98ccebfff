"""The port's data plane around the broker — copies of ``repro.data``'s
modules: sources and the ingest runner, payload codecs, sinks, lock
tracing, the socket transport (message codec, frames, ``BrokerServer``,
``RemoteBroker``), the durable log, the window-state store, windows, the
delivery lanes, and the metrics registry with its batch spans and HTTP
observability endpoint."""
