"""Near-real-time pipeline: sources → micro-batches → job → sinks.

The counterpart of ``repro/core/pipeline.py`` (paper Fig. 7 / Fig. 11): a
detector appends to broker topics, the streaming context cuts the stream
into micro-batch RDDs, the app's ``process`` runs on each batch (or, with a
``window``, on each complete window of records) with the bridge, and sinks
consume the results. Plain sinks take the ``BatchInfo``, keyed sinks
(``write_batch``) the result normalised to ``(key, value)`` items; either
runs serially before each batch's commit, or on its own delivery lane when
added with a :class:`~repro_torch.data.delivery.SinkPolicy`. With
``config.checkpoint_path`` the consumed offsets, and the open window's
state, survive a restart. :meth:`NearRealTimePipeline.serve_observability`
serves the metrics registry, the batch spans and a lag-based health verdict
over HTTP.
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
from repro_torch.data.window import windowed
from repro_torch.utils import resolve_device


@dataclass
class PipelineConfig:
    topics: Sequence[str] = ()
    batch_interval: float = 0.1
    max_records_per_partition: int | None = None
    checkpoint_path: str | None = None
    source_partitions: int = 1     # topic partitions for subscribed sources


@dataclass
class PipelineReport:
    batches: int = 0
    records: int = 0
    batch_latencies: list[float] = field(default_factory=list)

    @property
    def mean_latency(self) -> float:
        return (sum(self.batch_latencies) / len(self.batch_latencies)
                if self.batch_latencies else 0.0)

    @property
    def max_latency(self) -> float:
        return max(self.batch_latencies, default=0.0)

    def keeps_up(self, interval: float) -> bool:
        """Did every batch take at most ``interval`` seconds?"""
        return self.max_latency <= interval


class NearRealTimePipeline:
    """Generic streaming pipeline: the app supplies
    ``process(batch_rdd, info, bridge)``. The pipeline owns scheduling,
    offset commits, latency accounting and sinks. Without a ``bridge`` it
    builds a one-process :class:`TorchBridge` on the CUDA device."""

    def __init__(self, broker: Broker, config: PipelineConfig,
                 process: Callable[..., Any],
                 bridge: TorchBridge | None = None,
                 context: Context | None = None,
                 sinks: Sequence[Any] = (),
                 window: Any = None,
                 window_state: Any = None) -> None:
        """Without ``window``, ``process(batch_rdd, info, bridge)`` runs once
        per micro-batch. With ``window`` (a :class:`~repro_torch.data.window
        .WindowSpec`), records accumulate across micro-batches and
        ``process(records, window_info, bridge)`` runs once per *complete*
        window instead; call :meth:`flush_windows` at end-of-stream for the
        final partial window. ``window_state`` (a :class:`~repro_torch.data
        .state.WindowStateStore`, e.g. ``DurableStateStore``) makes the open
        window restart-safe: with ``config.checkpoint_path`` set, window
        state commits atomically with the consumed offsets, so a killed
        pipeline resumes mid-window with nothing lost or duplicated.
        ``sinks`` holds sinks and ``(sink, SinkPolicy)`` pairs."""
        self.broker = broker
        self.config = config
        self.context = context or Context()
        self.bridge = bridge or TorchBridge(device=resolve_device("cuda"))
        self.report = PipelineReport()
        self._process = process
        self._sinks: list[Callable[[BatchInfo], None]] = []
        self._keyed_sinks: list[Any] = []
        self.windower = None
        self.streaming = StreamingContext(
            self.context, broker,
            max_records_per_partition=config.max_records_per_partition,
            batch_interval=config.batch_interval,
            checkpoint_path=config.checkpoint_path)
        self.streaming.subscribe(config.topics)
        if window_state is not None and window is None:
            raise ValueError("window_state requires a window spec")
        if window is not None:
            on_batch = windowed(window, self._on_window, store=window_state)
            self.windower = on_batch.windower
            self.streaming.foreach_batch(on_batch)
        else:
            self.streaming.foreach_batch(self._on_batch)
        self.streaming.add_sink(self._on_sink)
        for sink in sinks:
            if isinstance(sink, tuple):      # (sink, SinkPolicy) pair
                self.add_sink(sink[0], policy=sink[1])
            else:
                self.add_sink(sink)

    def subscribe_source(self, source: Any, topic: str | None = None) -> str:
        """Feed the pipeline from a :class:`repro_torch.data.sources
        .SequenceSource`."""
        return self.streaming.subscribe_source(
            source, topic=topic, partitions=self.config.source_partitions)

    def add_sink(self, sink: Any, policy: Any = None,
                 name: str | None = None) -> None:
        """Accept a plain ``fn(BatchInfo)``, a batch-level sink with
        ``observe`` (e.g. ``MetricsSink``), or a keyed sink with
        ``write_batch``; a sink with both surfaces gets both.

        Without a ``policy`` the sink is written serially in the batch
        thread. With a :class:`~repro_torch.data.delivery.SinkPolicy` it
        moves onto its own delivery lane — worker thread, bounded queue,
        per-sink failure isolation — so a slow artifact store cannot stall
        the batch loop. Lane delivery is asynchronous: batches are
        guaranteed written only after :meth:`close`. Lane counters:
        :meth:`delivery_report`."""
        if policy is not None:
            # mirror the serial path: a sink exposing BOTH surfaces
            # (MetricsSink) gets an observe lane AND a keyed lane
            delivery = self.streaming.delivery
            observes = hasattr(sink, "observe")
            keyed = hasattr(sink, "write_batch")
            if observes:
                delivery.add_batch_sink(
                    sink.observe, policy,
                    name=((name or type(sink).__name__)
                          + ("-observe" if keyed else "")),
                    # close via one lane only when the sink has two
                    sink_close=(None if keyed
                                else getattr(sink, "close", None)))
            if keyed:
                delivery.add_sink(sink, policy, name=name)
            if not observes and not keyed:
                delivery.add_batch_sink(sink, policy, name=name)
            return
        if hasattr(sink, "observe"):
            self._sinks.append(sink.observe)
        if hasattr(sink, "write_batch"):
            self._keyed_sinks.append(sink)
        elif not hasattr(sink, "observe"):
            self._sinks.append(sink)

    def _on_batch(self, rdd: RDD, info: BatchInfo) -> Any:
        return self._process(rdd, info, self.bridge)

    def _on_window(self, records: list, winfo: Any) -> Any:
        return self._process(records, winfo, self.bridge)

    def flush_windows(self) -> list:
        """End-of-stream (windowed pipelines): fire the final partial window,
        deliver its results to the keyed sinks, and only then checkpoint the
        drained state — the sinks-before-commit contract of a batch, so a
        crash anywhere in between re-fires the partial window on restart
        (idempotent keys absorb the replay) instead of losing it. Returns
        the window results (``[]`` when nothing was pending)."""
        if self.windower is None:
            return []
        snapshot = self.windower.state()
        results = self.windower.flush()
        if not results:
            return []
        try:
            if self._keyed_sinks:
                items = describe_result_items(results,
                                              self.streaming._batch_index)
                for sink in self._keyed_sinks:
                    sink.write_batch(items)
        except BaseException:
            self.windower.restore_state(snapshot)   # flush stays retryable
            raise
        if self.config.checkpoint_path:
            self.streaming.checkpoint_now()
        return results

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

    # -- drive ---------------------------------------------------------------------
    def run(self, max_batches: int, wait_for_data: float = 1.0
            ) -> PipelineReport:
        """Up to ``max_batches`` micro-batches, waiting up to
        ``wait_for_data`` seconds for data (``StreamingContext
        .run_batches``)."""
        self.streaming.run_batches(max_batches, wait_for_data=wait_for_data)
        return self.report

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

    # -- observability ---------------------------------------------------------
    def serve_observability(self, address: tuple[str, int] = ("127.0.0.1", 0),
                            lag_policy: Any = None):
        """Start the pipeline's HTTP observability endpoint (``/metrics``,
        ``/metrics.json``, ``/traces``, ``/health``) — delegates to
        :meth:`repro_torch.core.dstream.StreamingContext.serve_observability`;
        stopped by :meth:`close`."""
        return self.streaming.serve_observability(address=address,
                                                  lag_policy=lag_policy)

    # -- parallel sink delivery ----------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Shut down the delivery lanes (see ``StreamingContext.close``).
        Call after the last run when sinks were added with a policy;
        ``drain=True`` guarantees every processed batch reached every sink."""
        self.streaming.close(drain=drain)

    def delivery_report(self) -> dict[str, dict[str, Any]]:
        """Per-sink-lane depth/latency/failure counters ({} when every sink
        runs serially) — the delivery-side complement of ``MetricsSink``."""
        if self.streaming._delivery is None:
            return {}
        return self.streaming.delivery.report()
