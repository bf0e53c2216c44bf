"""Shared window-driving loop for the host-fed ``fit_stream`` paths
(MultiLayerNetwork + ComputationGraph — one copy so transport tweaks
cannot silently diverge between them).

The loop accumulates batches from a DataSetIterator into windows of
``scan_steps``; a full uniform window flushes fused (one fit_scan
dispatch), while a ragged tail — iterator exhaustion mid-window or a
batch whose shape differs from the window's first — flushes per-batch.

A copy of ``deeplearning4j_tpu/nn/streaming_fit.py``; ``telemetry`` is
the net's ``optimize/telemetry.py:TrainTelemetry``.
"""

from __future__ import annotations

import time
from typing import Callable


def drive_stream_windows(iterator, scan_steps: int,
                         flush: Callable, batch_shape: Callable,
                         telemetry=None) -> None:
    """``flush(window, fused)`` trains a list of batches;
    ``batch_shape(ds)`` returns a comparable shape signature (host-side
    only — no device transfers). ``telemetry`` (a TrainTelemetry)
    accumulates the host wait on ``iterator.next()`` as the data-wait
    phase — with an async prefetcher keeping up, this reads near zero;
    a disk-bound run shows exactly where its step time went."""
    window, first_shape = [], None
    while True:
        t0 = time.perf_counter()
        ds = iterator.next()
        if telemetry is not None:
            telemetry.add_data_wait(time.perf_counter() - t0)
        if ds is None:
            if window:  # exhausted mid-window: always ragged here
                flush(window, False)
            break
        shape = batch_shape(ds)
        if window and shape != first_shape:
            # smaller tail batch can't stack with the window
            flush(window, False)
            window = []
        if not window:
            first_shape = shape
        window.append(ds)
        if len(window) == scan_steps:
            flush(window, True)
            window = []
