"""Observability: the streaming histogram (port of parts of
``deeplearning4j_tpu/profiler``)."""
