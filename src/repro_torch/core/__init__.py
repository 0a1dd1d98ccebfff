"""The data plane of the port: broker, RDDs, micro-batch streams, the bridge
handed to each batch, and the pipeline that composes them — trimmed copies of
``repro.core`` holding what the §III and §IV streaming paths use."""
