"""Sliding-window sub-matrix extraction (reference
util/MovingWindowMatrix.java): all window_rows x window_cols sub-matrices
of a 2-D matrix, optionally augmented with 90-degree rotations.

A copy of ``deeplearning4j_tpu/util/moving_window.py`` (numpy only), imports
rewritten to this package.
"""

from __future__ import annotations

from typing import List

import numpy as np


def moving_window_matrices(
    matrix: np.ndarray,
    window_rows: int,
    window_cols: int,
    rotate: int = 0,
) -> List[np.ndarray]:
    """Every aligned window of the given shape (stride = window size,
    matching the reference's non-overlapping windows), each followed by
    ``rotate`` extra 90-degree rotations of itself."""
    mat = np.asarray(matrix)
    r, c = mat.shape
    if window_rows > r or window_cols > c:
        raise ValueError(
            f"window {window_rows}x{window_cols} larger than matrix {r}x{c}"
        )
    out: List[np.ndarray] = []
    for i in range(0, r - window_rows + 1, window_rows):
        for j in range(0, c - window_cols + 1, window_cols):
            w = mat[i:i + window_rows, j:j + window_cols]
            out.append(w)
            cur = w
            for _ in range(rotate):
                cur = np.rot90(cur)
                out.append(cur)
    return out
