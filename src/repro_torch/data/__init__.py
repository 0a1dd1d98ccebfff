"""The port's data plane around the broker — copies of ``repro.data``'s
modules: sources and sinks, lock tracing, the message codec, the durable
log, the window-state store, windows and the delivery lanes."""
