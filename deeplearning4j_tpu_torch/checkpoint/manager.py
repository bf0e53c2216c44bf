"""Async step-numbered checkpoint manager.

Port of ``deeplearning4j_tpu/checkpoint/manager.py`` (the replacement
for the reference's ModelSavingActor and LocalFileModelSaver):

- **Async save**: the net is snapshotted to the host on the caller's
  thread (``util/model_serializer.snapshot``), then written on a
  background thread. The pending-save queue is bounded (default 2): a
  writer that falls behind makes ``save()`` block.
- **Atomic commits**: each step is written into ``step_N.tmp`` and
  renamed into place (``os.replace``), so a crash never leaves a torn
  checkpoint.
- **Retention**: the last ``keep_last_n`` steps plus the best-scoring
  one.
- **Iterator state**: the dataset iterator's position is saved beside
  the model and restored in place.

Each step directory holds ``model.zip`` (the JAX package's format: a
step directory either package wrote restores in the other) +
``meta.json`` (+ ``iterator.pkl``). ``restore`` loads onto ``device``.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    snapshot,
    write_snapshot,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep_last_n: int = 3,
        keep_best: bool = True,
        async_save: bool = True,
        max_pending: int = 2,
    ):
        self.directory = directory
        self.keep_last_n = keep_last_n
        self.keep_best = keep_best
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------
    def save(
        self,
        step: int,
        net,
        iterator=None,
        score: Optional[float] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Snapshot on the caller's thread, write on the background one.
        Blocks if ``max_pending`` saves are already in flight."""
        self._check_error()
        payload = {
            "snap": snapshot(net),
            "iterator_state": (
                iterator.state_dict() if iterator is not None else None
            ),
            "score": score,
            "metadata": metadata or {},
        }
        if self.async_save:
            self._ensure_worker()
            self._queue.put((step, payload))
        else:
            self._write(step, payload)

    def wait_until_finished(self) -> None:
        self._queue.join()
        self._check_error()

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            step, payload = self._queue.get()
            try:
                self._write(step, payload)
            except BaseException as e:
                self._error = e
            finally:
                self._queue.task_done()

    def _check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        with self._lock:
            final = os.path.join(self.directory, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            write_snapshot(payload["snap"], os.path.join(tmp, "model.zip"))
            meta = {
                "step": step,
                "iteration": payload["snap"]["iteration"],
                "kind": payload["snap"]["kind"],
                "score": payload["score"],
                "metadata": payload["metadata"],
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if payload["iterator_state"] is not None:
                with open(os.path.join(tmp, "iterator.pkl"), "wb") as f:
                    pickle.dump(payload["iterator_state"], f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

    # ------------------------------------------------------------------
    # Retention
    # ------------------------------------------------------------------
    def _all_steps_locked(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _score_of(self, step: int) -> Optional[float]:
        try:
            with open(
                os.path.join(self.directory, f"step_{step}", "meta.json")
            ) as f:
                return json.load(f).get("score")
        except OSError:
            return None

    def _gc(self) -> None:
        steps = self._all_steps_locked()
        keep = set(steps[-self.keep_last_n:]) if self.keep_last_n else set(
            steps
        )
        if self.keep_best:
            scored = [(s, self._score_of(s)) for s in steps]
            scored = [(s, sc) for s, sc in scored if sc is not None]
            if scored:
                best = min(scored, key=lambda t: t[1])[0]
                keep.add(best)
        for s in steps:
            if s not in keep:
                shutil.rmtree(
                    os.path.join(self.directory, f"step_{s}"),
                    ignore_errors=True,
                )

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------
    def all_steps(self):
        with self._lock:
            return self._all_steps_locked()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        with self._lock:
            scored = [
                (s, self._score_of(s)) for s in self._all_steps_locked()
            ]
        scored = [(s, sc) for s, sc in scored if sc is not None]
        return min(scored, key=lambda t: t[1])[0] if scored else None

    def restore(
        self, step: Optional[int] = None, iterator=None, device="cuda"
    ) -> Tuple[Any, Dict[str, Any]]:
        """Returns (net on ``device``, meta). If ``iterator`` is given,
        its position is restored in place."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        net = restore_model(os.path.join(path, "model.zip"), device=device)
        ipath = os.path.join(path, "iterator.pkl")
        if iterator is not None and os.path.exists(ipath):
            with open(ipath, "rb") as f:
                iterator.load_state_dict(pickle.load(f))
        return net, meta
