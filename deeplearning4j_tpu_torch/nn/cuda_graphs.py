"""Loops captured as CUDA graphs: the port's counterpart of the JAX
package's jitted ``lax.scan`` executables.

A :class:`GraphRunner` holds one ``torch.cuda.CUDAGraph`` per key (for
``MultiLayerNetwork.generate`` a pow2 bucket, batch, dtype and params
version; for ``MultiLayerNetwork.fit_scan`` the train step of one batch
shape, dtype, mask set and updater layout; for ``DecodeEngine`` its
decode round and its fused K-round windows). On CPU tensors it runs
the step body eagerly: the CPU is what the caller asked for, not a
fallback. On a CUDA device the first call for a key captures the body,
and every call replays it; a capture that fails raises, and nothing
runs eagerly on the card in its place.

Inputs and outputs go through static buffers. The tensors of a key's
first call ARE the graph's inputs; each later call copies its tensors
into them, leaf by leaf, except those that are the same tensors (the
serving engine passes its persistent pool and token vector, so nothing
is copied for them). The outputs are the graph's own tensors, which the
next replay of the same key overwrites.

Before capturing, the body runs once on copies of the inputs on a side
stream: it builds and loads the ctypes-bound kernels, sets their
shared-memory attributes and initialises cuBLAS outside the capture. The
generators the runner was given have their state put back after that run
and are registered with each graph, so a replay draws fresh numbers.

Every graph of a runner is captured into one private memory pool
(``torch.cuda.graph_pool_handle``): its graphs never replay at the same
time (one engine's round and its fused windows, ``generate``'s buckets,
``fit_scan``'s keys). A graph's temporaries may then sit where another
graph's outputs live, so a graph's outputs are valid only until the
next replay of ANY graph of the runner: every caller consumes them
first (a copy enqueued on the stream before the next replay is
consumption). ``memory[key]`` is the card's reserved memory grown by
that key's capture: what the graph added to the pool; ``seconds[key]``
the capture's wall time, its warm-up run and the graph's instantiation
included.

A kernel wrapper counts a launch when its Python code runs; under
capture that code runs once and launches nothing. The runner takes those
counts back after the capture and adds them again on every replay, so a
wrapper's count stays the number of times its kernel was launched.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Iterable

import torch

from deeplearning4j_tpu_torch.nn.layers import attention, convolution
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map


def _on_card(leaves) -> bool:
    """Whether a body's input tensors live on a CUDA device."""
    return bool(leaves) and leaves[0].device.type == "cuda"


def _counters() -> list:
    """The launch counters of the kernels a graph can hold: K1 forward
    and backward, K2, and K3 (all launches, and those on the tensor
    cores)."""
    return [(attention.flash_attention, "launches"),
            (attention.flash_attention, "bwd_launches"),
            (attention.paged_attention, "launches"),
            (attention.paged_attention, "chunk_launches"),
            (convolution.conv_taps, "launches"),
            (convolution.conv_taps, "mma_launches")]


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class GraphRunner:
    """One captured graph per key; see the module docstring.

    ``len(runner)`` is the number of graphs it holds (the port's
    ``compile_counts`` for these paths), ``keys()`` their keys;
    ``captures`` counts every capture it has made, so a repeat that
    captured again shows."""

    def __init__(self, generators: Iterable[torch.Generator] = ()):
        self.generators = tuple(generators)
        self._pool = None
        self._graphs: Dict[Hashable, _Graph] = {}
        self.captures = 0
        #: reserved device bytes each key's capture added, and its wall
        self.memory: Dict[Hashable, int] = {}
        self.seconds: Dict[Hashable, float] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def keys(self) -> list:
        return list(self._graphs)

    def drop(self) -> None:
        """Forget every graph (their memory pool goes with them)."""
        self._graphs.clear()
        self.memory.clear()
        self.seconds.clear()
        self._pool = None

    def run(self, key: Hashable, body: Callable, inputs: Any) -> Any:
        """``body(inputs)``: eagerly for CPU tensors; on a CUDA device by
        replaying the graph of ``key``, captured at its first call."""
        leaves = tree_leaves(inputs)
        if not _on_card(leaves):
            return body(inputs)
        g = self._graphs.get(key)
        if g is None:
            # the graph's static inputs: these tensors, in dicts of the
            # runner's own (a caller may reuse its dicts for later calls)
            g = self._graphs[key] = self._capture(
                body, tree_map(lambda t: t, inputs), key)
        else:
            static = tree_leaves(g.inputs)
            if len(static) != len(leaves):
                raise ValueError(
                    f"graph {key!r}: {len(leaves)} input tensors, captured "
                    f"with {len(static)}")
            for dst, src in zip(static, leaves):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"graph {key!r}: input {tuple(src.shape)} "
                        f"{src.dtype}, captured with {tuple(dst.shape)} "
                        f"{dst.dtype}")
                if src is not dst:
                    dst.copy_(src)
        g.graph.replay()
        for (obj, attr), n in g.launches:
            setattr(obj, attr, getattr(obj, attr) + n)
        return g.outputs

    def _capture(self, body: Callable, inputs: Any, key: Hashable
                 ) -> _Graph:
        t0 = time.perf_counter()
        states = [gen.get_state() for gen in self.generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(tree_map(torch.clone, inputs))
        torch.cuda.current_stream().wait_stream(side)
        for gen, st in zip(self.generators, states):
            gen.set_state(st)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        counters = _counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        # the capture empties the allocator's cache first: measure from
        # there, so the growth is the graph's pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = body(inputs)
        launches = []
        for (obj, attr), n0 in zip(counters, before):
            launches.append(((obj, attr), getattr(obj, attr) - n0))
            setattr(obj, attr, n0)
        self.memory[key] = torch.cuda.memory_reserved() - r0
        self.seconds[key] = time.perf_counter() - t0
        self.captures += 1
        return _Graph(graph, inputs, outputs, tuple(launches))
