"""Near-real-time pipeline: sources → micro-batches → job → sinks.

The counterpart of ``repro/core/pipeline.py`` (paper Fig. 7 / Fig. 11): a
detector appends to broker topics, the streaming context cuts the stream
into micro-batch RDDs, the app's ``process`` runs on each batch with the
bridge, and sinks consume the results. Sinks run serially, before each
batch's commit; plain sinks take the ``BatchInfo``, keyed sinks
(``write_batch``) the result normalised to ``(key, value)`` items. Windows,
delivery lanes and the observability server of the reference are left out.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import BatchInfo, StreamingContext
from repro_torch.core.rdd import RDD, Context
from repro_torch.data.sinks import describe_result_items
from repro_torch.utils import resolve_device


@dataclass
class PipelineConfig:
    topics: Sequence[str] = ()
    batch_interval: float = 0.1
    max_records_per_partition: int | None = None
    source_partitions: int = 1     # topic partitions for subscribed sources


@dataclass
class PipelineReport:
    batches: int = 0
    records: int = 0
    batch_latencies: list[float] = field(default_factory=list)


class NearRealTimePipeline:
    """Generic streaming pipeline: the app supplies
    ``process(batch_rdd, info, bridge)``. The pipeline owns scheduling,
    offset commits, latency accounting and sinks. Without a ``bridge`` it
    builds a one-process :class:`TorchBridge` on the CUDA device."""

    def __init__(self, broker: Broker, config: PipelineConfig,
                 process: Callable[..., Any],
                 bridge: TorchBridge | None = None,
                 context: Context | None = None,
                 sinks: Sequence[Any] = ()) -> None:
        self.broker = broker
        self.config = config
        self.context = context or Context()
        self.bridge = bridge or TorchBridge(device=resolve_device("cuda"))
        self.report = PipelineReport()
        self._process = process
        self._sinks: list[Callable[[BatchInfo], None]] = []
        self._keyed_sinks: list[Any] = []
        self.streaming = StreamingContext(
            self.context, broker,
            max_records_per_partition=config.max_records_per_partition)
        self.streaming.subscribe(config.topics)
        self.streaming.foreach_batch(self._on_batch)
        self.streaming.add_sink(self._on_sink)
        for sink in sinks:
            self.add_sink(sink)

    def subscribe_source(self, source: Any, topic: str | None = None) -> str:
        """Feed the pipeline from a :class:`repro_torch.data.sources
        .SequenceSource`."""
        return self.streaming.subscribe_source(
            source, topic=topic, partitions=self.config.source_partitions)

    def add_sink(self, sink: Any) -> None:
        """Accept a plain ``fn(BatchInfo)``, a batch-level sink with
        ``observe`` (e.g. ``MetricsSink``), or a keyed sink with
        ``write_batch``; a sink with both surfaces gets both."""
        if hasattr(sink, "observe"):
            self._sinks.append(sink.observe)
        if hasattr(sink, "write_batch"):
            self._keyed_sinks.append(sink)
        elif not hasattr(sink, "observe"):
            self._sinks.append(sink)

    def _on_batch(self, rdd: RDD, info: BatchInfo) -> Any:
        return self._process(rdd, info, self.bridge)

    def _on_sink(self, info: BatchInfo) -> None:
        self.report.batches += 1
        self.report.records += info.num_records
        self.report.batch_latencies.append(info.processing_time)
        for sink in self._sinks:
            sink(info)
        if self._keyed_sinks:
            items = describe_result_items(info.result, info.index)
            for sink in self._keyed_sinks:
                sink.write_batch(items)

    def run_until_drained(self, producer_done: Callable[[], bool] | None = None,
                          idle_timeout: float = 2.0) -> PipelineReport:
        """Process batches until the producer finished AND the topics drained.

        With subscribed sources, ``producer_done`` defaults to "every source
        exhausted"."""
        if producer_done is None:
            producer_done = lambda: self.streaming.sources_exhausted  # noqa: E731
        last_data = time.monotonic()
        while True:
            info = self.streaming.run_one_batch()
            if info is not None:
                last_data = time.monotonic()
                continue
            if producer_done() and time.monotonic() - last_data > min(
                    idle_timeout, 10 * self.config.batch_interval):
                break
            time.sleep(max(self.config.batch_interval / 10, 0.001))
        return self.report
