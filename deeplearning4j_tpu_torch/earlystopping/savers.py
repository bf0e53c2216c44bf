"""Model savers for early stopping checkpoints.

Port of ``deeplearning4j_tpu/earlystopping/savers.py`` (reference
earlystopping/saver/{InMemoryModelSaver, LocalFileModelSaver.java:76-86}):
a checkpoint is the (conf JSON, params, updater state) triple, here the
model zip. ``LocalFileModelSaver`` restores either network kind, on the
device it was built with.
"""

from __future__ import annotations

import os


class ModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(ModelSaver):
    def __init__(self, directory: str, device="cuda"):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, which: str) -> str:
        return os.path.join(self.directory, which)

    def save_best_model(self, net, score: float) -> None:
        net.save(self._path("bestModel"))

    def save_latest_model(self, net, score: float) -> None:
        net.save(self._path("latestModel"))

    def _load(self, which: str):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
        )

        path = self._path(which)
        if not os.path.exists(path):
            return None
        return restore_model(path, device=self.device)

    def get_best_model(self):
        return self._load("bestModel")

    def get_latest_model(self):
        return self._load("latestModel")
