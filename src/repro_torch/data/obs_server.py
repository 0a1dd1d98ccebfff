"""HTTP observability endpoint, the counterpart of
``repro/data/obs_server.py``: the registry and trace log served live.

Stdlib-only (``http.server``), one daemon thread, bound to an ephemeral port
by default — small enough to run inside a test and real enough for a
Prometheus scrape config or a dashboard poll loop (the role MongoDB plays
for DELTA's visualization consumer and InfluxDB/Grafana for CFAA).

Routes:

=====================  =====================================================
``GET /metrics``       Prometheus text exposition of the whole registry
``GET /metrics.json``  full registry: values, histogram buckets, and each
                       metric's ring-buffer ``(t, value)`` series
``GET /traces?last=N`` the most recent N batch-epoch trace spans (default
                       32): per-stage timings tagged with checkpoint epoch
``GET /health``        ``ok`` / ``degraded`` verdict: per-topic consumer lag
                       judged against a lag policy's ``scale_up_lag``
                       watermark (HTTP 200 / 503, so a load balancer or
                       systemd watchdog can consume it without parsing)
=====================  =====================================================

Each scrape of ``/metrics`` or ``/metrics.json`` calls
:meth:`~repro_torch.data.metrics.MetricsRegistry.sample` first, so the ring-buffer
series advance at scrape frequency — the Prometheus pull model, with the
last ``ring_size`` points kept in-process for consumers that cannot run a
TSDB.

Start one via
:meth:`repro_torch.core.dstream.StreamingContext.serve_observability` /
``NearRealTimePipeline.serve_observability`` (wires the context's
registry, trace log, and lag-based health in one call), or standalone::

    server = ObservabilityServer(registry=get_registry()).start()
    print(server.url)          # e.g. http://127.0.0.1:43215

:func:`scrape_stream` reads a running endpoint back *through HTTP* and rolls
its spans up per stage, as the reference's ptycho example prints them.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from repro_torch.data.metrics import MetricsRegistry, TraceLog, get_registry
from repro_torch.utils import get_logger

log = get_logger(__name__)


def lag_health(lag_of: Callable[[], "dict[str, int]"],
               lag_policy: Any = None) -> Callable[[], dict]:
    """Build a ``/health`` callback from a live per-topic lag snapshot and
    (optionally) a lag policy — any object with ``scale_up_lag`` and
    ``scale_down_lag``, as the reference's ``LagPolicy`` has — whose
    ``scale_up_lag`` watermark defines *degraded*. Without a policy the
    endpoint reports lags but never degrades (no watermark to judge by)."""
    up = getattr(lag_policy, "scale_up_lag", None)
    down = getattr(lag_policy, "scale_down_lag", None)

    def health() -> dict:
        try:
            lags = dict(lag_of())
        except Exception as e:         # a torn-down context must not 500
            return {"status": "degraded", "error": repr(e), "topics": {}}
        degraded = [t for t, lag in lags.items()
                    if up is not None and lag >= up]
        return {
            "status": "degraded" if degraded else "ok",
            "topics": {t: {"lag": lag,
                           "scale_up_lag": up, "scale_down_lag": down,
                           "ok": t not in degraded}
                       for t, lag in lags.items()},
        }

    return health


class _Handler(BaseHTTPRequestHandler):
    # set per-server via functools-free subclassing in ObservabilityServer
    registry: MetricsRegistry
    traces: TraceLog | None
    health_fn: Callable[[], dict] | None

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("obs: " + fmt, *args)

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj: Any, status: int = 200) -> None:
        self._send(status, json.dumps(obj, default=_jsonable).encode(),
                   "application/json")

    def do_GET(self) -> None:          # noqa: N802 - BaseHTTPRequestHandler
        try:
            url = urlparse(self.path)
            if url.path == "/metrics":
                self.registry.sample()
                self._send(200, self.registry.prometheus_text().encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/metrics.json":
                self.registry.sample()
                self._send_json(self.registry.snapshot())
            elif url.path == "/traces":
                qs = parse_qs(url.query)
                try:
                    last = int(qs.get("last", ["32"])[0])
                except ValueError:
                    self._send_json({"error": "last must be an integer"},
                                    status=400)
                    return
                spans = (self.traces.last(last)
                         if self.traces is not None else [])
                self._send_json({"spans": [s.as_dict() for s in spans],
                                 "recorded": getattr(self.traces,
                                                     "recorded", 0)})
            elif url.path == "/health":
                verdict = (self.health_fn() if self.health_fn is not None
                           else {"status": "ok", "topics": {}})
                self._send_json(
                    verdict,
                    status=200 if verdict.get("status") == "ok" else 503)
            else:
                self._send_json({"error": f"no route {url.path}",
                                 "routes": ["/metrics", "/metrics.json",
                                            "/traces", "/health"]},
                                status=404)
        except BrokenPipeError:        # client went away mid-response
            pass
        except Exception as e:         # never kill the serving thread
            log.warning("obs endpoint error on %s: %r", self.path, e)
            try:
                self._send_json({"error": repr(e)}, status=500)
            except OSError:
                pass


def _jsonable(obj: Any) -> Any:
    as_dict = getattr(obj, "as_dict", None)
    if as_dict is not None:
        return as_dict()
    return repr(obj)


class ObservabilityServer:
    """Serve a registry (+ optional trace log and health callback) over HTTP.

    ``address`` is ``(host, port)``; port 0 binds an ephemeral port — read
    it back from :attr:`address` / :attr:`url` after :meth:`start`.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 traces: TraceLog | None = None,
                 health_fn: Callable[[], dict] | None = None,
                 address: tuple[str, int] = ("127.0.0.1", 0)) -> None:
        self.registry = registry if registry is not None else get_registry()
        self.traces = traces
        self.health_fn = health_fn
        self._requested = address
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.address: tuple[str, int] | None = None

    @property
    def url(self) -> str:
        if self.address is None:
            raise RuntimeError("server not started")
        return f"http://{self.address[0]}:{self.address[1]}"

    def start(self) -> "ObservabilityServer":
        if self._httpd is not None:
            return self
        # staticmethod: a plain-function health_fn stored on the class would
        # otherwise bind as a method and receive the handler as an argument
        handler = type("_BoundHandler", (_Handler,), {
            "registry": self.registry, "traces": self.traces,
            "health_fn": (staticmethod(self.health_fn)
                          if self.health_fn is not None else None)})
        self._httpd = ThreadingHTTPServer(self._requested, handler)
        self._httpd.daemon_threads = True
        self.address = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-server")
        self._thread.start()
        log.info("observability endpoint on %s", self.url)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def serve_observability(registry: MetricsRegistry | None = None,
                        traces: TraceLog | None = None,
                        health_fn: Callable[[], dict] | None = None,
                        address: tuple[str, int] = ("127.0.0.1", 0)
                        ) -> ObservabilityServer:
    """Start an :class:`ObservabilityServer`; returns it with
    :attr:`~ObservabilityServer.address` bound."""
    return ObservabilityServer(registry, traces, health_fn, address).start()


def scrape_stream(url: str, last: int = 1024,
                  timeout: float = 10.0) -> dict[str, Any]:
    """Fetch ``/metrics.json`` and ``/traces?last=N`` from the endpoint at
    ``url`` through HTTP and roll the stream up: the spans and their epochs,
    the unlabelled ``stream_records_total``/``stream_batches_total``, and
    each stage's total seconds and share of the spans' total, largest
    first. Returns those with the spans themselves."""
    with urllib.request.urlopen(url + "/metrics.json", timeout=timeout) as r:
        snap = json.load(r)
    with urllib.request.urlopen(f"{url}/traces?last={last}",
                                timeout=timeout) as r:
        spans = json.load(r)["spans"]
    totals: dict[str, float] = {}
    for span in spans:
        for name, dt in span["stages"].items():
            totals[name] = totals.get(name, 0.0) + dt
    span_total = sum(span["total_s"] for span in spans)
    values = {m["name"]: m["value"] for m in snap["metrics"]
              if not m["labels"]}
    return {
        "url": url, "spans": spans,
        "epochs": ((spans[0]["epoch"], spans[-1]["epoch"]) if spans
                   else None),
        "records": values.get("stream_records_total", 0),
        "batches": values.get("stream_batches_total", 0),
        "span_total_s": span_total,
        "stages": {name: {"seconds": dt,
                          "share": dt / max(span_total, 1e-9)}
                   for name, dt in sorted(totals.items(),
                                          key=lambda kv: -kv[1])},
    }


def print_stream_scrape(scrape: dict[str, Any]) -> None:
    """Print :func:`scrape_stream`'s roll-up as the reference's ptycho
    example prints its observability block."""
    first, last = scrape["epochs"] or ("-", "-")
    print(f"observability: {len(scrape['spans'])} batch spans (epochs "
          f"{first}..{last}) from {scrape['url']}, "
          f"{scrape['records']:.0f} records via {scrape['batches']:.0f} "
          f"batches; per-stage time:")
    for name, st in scrape["stages"].items():
        print(f"  {name:16s} {st['seconds']:9.4f}s  "
              f"({100 * st['share']:5.1f}%)")
