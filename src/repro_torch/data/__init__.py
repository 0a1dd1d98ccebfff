"""Sources and sinks of the port's streaming path — trimmed copies of
``repro.data.sources`` and ``repro.data.sinks``."""
