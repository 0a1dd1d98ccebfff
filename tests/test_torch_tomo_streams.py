"""The §IV partitions on the card, each executor thread's on a CUDA stream
of its own (``apps/tomo/stream.py:reconstruct_partition``).

Marked ``card``: these need an NVIDIA GPU and skip without one, decided in
the ``card`` fixture. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_tomo_streams.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.apps.tomo import solver
from repro_torch.apps.tomo.stream import reconstruct_partition
from repro_torch.data import metrics as M
from repro_torch.kernels.art import ops as art_ops

# a sweep of 16 slices at this width takes milliseconds, so that four
# enqueued at once overlap on the card
NRAY, NANGLES, PARTS, PER = 128, 76, 4, 16
JOIN_S = 300.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the executors' streams and the ART "
                    "kernel run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_torch_tomo_partitions_overlap_on_their_own_streams(card,
                                                            monkeypatch):
    """Four threads run ``reconstruct_partition`` at once, as a batch's
    executors do: each on a stream of its own (none the default stream),
    each block bit-equal to the same partition run alone on the default
    stream, at least one ART call enqueued while another's was still on the
    card (``in_flight``), and ``art_own_stream_calls_total`` up by 4."""
    cfg = solver.TomoConfig(nray=NRAY, angles=tuple(
        np.linspace(-75, 75, NANGLES).tolist()), iterations=2)
    _, _, sino = solver.simulate_tilt_series(cfg, PARTS * PER, seed=3,
                                             device=card)
    parts = [[(i, sino[i]) for i in range(p * PER, (p + 1) * PER)]
             for p in range(PARTS)]
    serial = [solver.reconstruct_slices(torch.from_numpy(np.stack(
        [b for _, b in items])).to(card), cfg).cpu().numpy()
        for items in parts]

    streams, real = {}, art_ops.art_reconstruct

    def spy(*args, **kw):
        streams[threading.get_ident()] = torch.cuda.current_stream(
            card).cuda_stream
        return real(*args, **kw)

    monkeypatch.setattr(art_ops, "art_reconstruct", spy)
    results, errors = [None] * PARTS, []
    barrier = threading.Barrier(PARTS)
    reg = M.MetricsRegistry()
    prev = M.set_registry(reg)
    try:
        rec = M.TraceLog().begin(0, PARTS * PER)
        with rec.stage("batch_fn") as stage:
            def run(p):
                try:
                    with M.span("task", parent=stage,
                                attrs={"partition": p}):
                        barrier.wait(timeout=JOIN_S)
                        results[p] = reconstruct_partition(parts[p], cfg,
                                                           card)
                except Exception as exc:    # read below, on the test thread
                    errors.append(exc)

            threads = [threading.Thread(target=run, args=(p,))
                       for p in range(PARTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        batch = rec.finish(0)
    finally:
        M.set_registry(prev)
    assert errors == []
    assert len(set(streams.values())) == PARTS
    assert torch.cuda.default_stream(card).cuda_stream not in set(
        streams.values())
    for p, (idx, block) in enumerate(results):
        assert idx == list(range(p * PER, (p + 1) * PER))
        np.testing.assert_array_equal(block, serial[p])
    arts = [s for s in batch.spans if s.name == "art"]
    assert len(arts) == PARTS
    flights = [s.attrs["in_flight"] for s in arts]
    assert max(flights) >= 1 and all(0 <= n < PARTS for n in flights), \
        flights
    assert all(s.device_s is not None and s.device_s > 0 for s in arts)
    assert reg.counter("art_own_stream_calls_total").value() == PARTS
