"""Observability: the span tracer with its Prometheus exposition, the
streaming histogram, the iteration listener that feeds a tracer, and a
device trace hook (port of ``deeplearning4j_tpu/profiler``)."""

from deeplearning4j_tpu_torch.profiler.tracer import (
    Histogram,
    ProfilerIterationListener,
    Tracer,
    device_trace,
    parse_exposition,
)

__all__ = ["Histogram", "Tracer", "ProfilerIterationListener",
           "device_trace", "parse_exposition"]
