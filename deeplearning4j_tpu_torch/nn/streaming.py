"""Streaming helpers shared by the scheduler and the serving engine
(port of ``scan_length_bucket`` from ``deeplearning4j_tpu/nn/
streaming.py``)."""

from __future__ import annotations


def scan_length_bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum): the pow2 bucket that bounds
    the number of distinct prefill widths (and so of padded shapes) at
    O(log max_len) under varied request lengths."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()
