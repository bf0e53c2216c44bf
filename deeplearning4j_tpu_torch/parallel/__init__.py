"""Parallelism helpers of the torch package (port of
``deeplearning4j_tpu/parallel``): the single-device half of expert
parallelism. The mesh-bound paths (``ep_axis``, ``ring_axis``, data and
pipeline parallelism) wait for ROADMAP Queue 1 item 11."""
