"""A fixture the port's CPU test modules share: torch at one intra-op
thread while the module runs.

The port's test tensors are tiny, so torch gains nothing from its
thread pool; but the suite runs in several worker processes at once,
and on oversubscribed cores every parallel region waits for each of
its threads' time slices. A module pulls the fixture in with
``from torch_port_threads import one_torch_thread  # noqa: F401`` (an
autouse fixture applies to the module that holds it); the thread
count is put back after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
