"""Raw-directory → train/test split (reference
datasets/rearrange/LocalUnstructuredDataFormatter.java).

Input layout: ``root/<class-name>/<files...>``. Output layout::

    dest/split/train/<class-name>/<files...>
    dest/split/test/<class-name>/<files...>

Split is deterministic under ``seed``; files are copied (or moved).

A copy of ``deeplearning4j_tpu/datasets/rearrange.py`` (numpy only), imports
rewritten to this package.
"""

from __future__ import annotations

import enum
import os
import shutil
from typing import Dict, List

import numpy as np


class LabelingType(enum.Enum):
    DIRECTORY = "directory"  # class = parent dir name (only mode here)


class LocalUnstructuredDataFormatter:
    def __init__(
        self,
        dest_dir: str,
        src_dir: str,
        percent_train: float = 0.8,
        seed: int = 123,
        move: bool = False,
    ):
        if not 0.0 < percent_train < 1.0:
            raise ValueError("percent_train must be in (0, 1)")
        self.dest_dir = dest_dir
        self.src_dir = src_dir
        self.percent_train = percent_train
        self.seed = seed
        self.move = move
        self._counts: Dict[str, int] = {}

    def rearrange(self) -> None:
        self._counts = {}
        rng = np.random.default_rng(self.seed)
        classes = sorted(
            d for d in os.listdir(self.src_dir)
            if os.path.isdir(os.path.join(self.src_dir, d))
        )
        if not classes:
            raise ValueError(f"no class subdirectories in {self.src_dir}")
        for cls in classes:
            files: List[str] = sorted(
                f for f in os.listdir(os.path.join(self.src_dir, cls))
                if os.path.isfile(os.path.join(self.src_dir, cls, f))
            )
            perm = rng.permutation(len(files))
            n_train = max(1, int(round(len(files) * self.percent_train)))
            if len(files) > 1:
                n_train = min(n_train, len(files) - 1)
            for rank, idx in enumerate(perm):
                part = "train" if rank < n_train else "test"
                src = os.path.join(self.src_dir, cls, files[idx])
                dst_dir = os.path.join(self.dest_dir, "split", part, cls)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, files[idx])
                (shutil.move if self.move else shutil.copy2)(src, dst)
                self._counts[part] = self._counts.get(part, 0) + 1

    def num_examples_total(self) -> int:
        return sum(self._counts.values())

    def num_test_examples(self) -> int:
        return self._counts.get("test", 0)

    def get_train_dir(self) -> str:
        return os.path.join(self.dest_dir, "split", "train")

    def get_test_dir(self) -> str:
        return os.path.join(self.dest_dir, "split", "test")
