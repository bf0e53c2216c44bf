"""Replica lifecycle handles: the process-management layer under the
elastic fleet controller.

A copy of ``deeplearning4j_tpu/serving/replica_proc.py`` with imports
rewritten: :class:`LocalReplica` wraps the port's gateway, and a
:class:`ReplicaProcess` child is any argv, the port's ``python -m
deeplearning4j_tpu_torch.cli serve`` (ready pattern ``"serving on"``)
among them.

``scripts/router_soak.py`` grew the first subprocess-replica manager —
spawn a child gateway, wait for its READY line on a reaper thread,
SIGKILL it for chaos, terminate it for cleanup. The fleet controller
(serving/controller.py) needs exactly that machinery to BREATHE the
fleet at runtime (spawn on SLO pressure, reap on idle, replace during
rolling upgrades), so it is hoisted here as a reusable pair:

- :class:`ReplicaProcess` — a real subprocess replica: any argv whose
  child prints a ready line (``READY <address>`` by convention; the
  pattern is a knob so ``cli serve`` children work too) once its
  gateway is listening. ``sigkill()`` is the chaos path (no drain, no
  goodbye), ``shutdown()`` the polite one (SIGTERM, then SIGKILL past
  the grace period).
- :class:`LocalReplica` — an in-process stand-in wrapping a
  :class:`~deeplearning4j_tpu_torch.serving.ServingGateway`, whose
  ``hard_kill`` is network-indistinguishable from process death
  (connection refused, streams end without terminal). The tier-1
  soaks and controller tests scale a "fleet" in one process at a
  fraction of the subprocess wall cost.

Both expose the same handle protocol the controller scales over:
``address`` / ``replica_id`` / ``alive`` / ``sigkill()`` /
``shutdown()``. A *replica factory* is any callable
``factory(replica_id) -> handle`` returning a READY handle — the
controller never knows whether its fleet is processes or objects.
"""

from __future__ import annotations

import contextlib
import socket
import subprocess
import threading
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    """An ephemeral port that was free a moment ago (the child binds
    it after a tiny race window — fine for localhost test fleets)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ReplicaProcess:
    """One subprocess replica and the handles to manage its life.

    ``argv`` is the full child command; the child must print a line
    starting with ``ready_pattern`` (default ``"READY"``) to stdout
    once its gateway is accepting connections — that line is the
    boot handshake :meth:`wait_ready` blocks on. ``address`` is where
    the router reaches the replica (``host:port``)."""

    def __init__(self, argv: Sequence[str], replica_id: str,
                 port: int, host: str = "127.0.0.1",
                 ready_pattern: str = "READY",
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None):
        self.replica_id = str(replica_id)
        self.port = int(port)
        self.host = host
        self.address = f"{host}:{port}"
        self.ready_pattern = ready_pattern
        self.boot_lines: List[str] = []
        self.proc = subprocess.Popen(
            list(argv), stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=env, cwd=cwd)

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_ready(self, timeout_s: float = 120.0) -> None:
        """Block until the child printed its ready line. readline()
        blocks with no deadline of its own, so a wedged child (stuck
        in device init, never printing READY and never exiting) would
        hang the caller forever — read on a reaper thread and enforce
        the deadline with join(). The lines the child printed before
        its ready line stay in ``boot_lines`` (a ``serve`` child
        reports its kernel builds there)."""
        result: Dict[str, str] = {}
        pattern = self.ready_pattern

        def read():
            while True:
                line = self.proc.stdout.readline().decode()
                if line and not line.lstrip().startswith(pattern):
                    self.boot_lines.append(line.rstrip("\n"))
                if not line or line.lstrip().startswith(pattern):
                    result["line"] = line
                    return

        t = threading.Thread(target=read, daemon=True,
                             name=f"replica-ready-{self.replica_id}")
        t.start()
        t.join(timeout=timeout_s)
        if result.get("line", "").lstrip().startswith(pattern):
            return
        raise RuntimeError(
            f"replica {self.replica_id} never became ready within "
            f"{timeout_s}s (last output {result.get('line')!r})")

    def sigkill(self) -> None:
        """Chaos path: SIGKILL — no drain, no cleanup, no goodbye."""
        self.proc.kill()
        self.proc.wait(timeout=30)

    def shutdown(self) -> None:
        """Polite teardown: SIGTERM, SIGKILL past the grace period,
        stdout pipe closed (the fd-leak gates count it)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.proc.stdout.close()


class LocalReplica:
    """In-process replica handle: a gateway whose ``hard_kill`` is
    the SIGKILL stand-in. ``engine`` is a ready
    :class:`~deeplearning4j_tpu_torch.serving.DecodeEngine` (the caller
    owns net/knob/throttle choices); everything else forwards to
    :class:`~deeplearning4j_tpu_torch.serving.ServingGateway`."""

    def __init__(self, engine, replica_id: str, **gateway_kwargs):
        from deeplearning4j_tpu_torch.serving.gateway import ServingGateway

        gateway_kwargs.setdefault("keepalive_s", 0.1)
        self.replica_id = str(replica_id)
        self.gw = ServingGateway(engine, replica_id=self.replica_id,
                                 **gateway_kwargs).start()
        self.address = (f"{self.gw._service.host}:"
                        f"{self.gw._service.port}")

    @property
    def alive(self) -> bool:
        return not self.gw._stopped

    def sigkill(self) -> None:
        self.gw.hard_kill()

    def shutdown(self) -> None:
        with contextlib.suppress(Exception):
            self.gw.close()


def shutdown_all(handles: List) -> None:
    """Best-effort teardown of a whole fleet of handles (soak/test
    cleanup; errors suppressed so one wreck cannot leak the rest)."""
    for h in handles:
        with contextlib.suppress(Exception):
            h.shutdown()
