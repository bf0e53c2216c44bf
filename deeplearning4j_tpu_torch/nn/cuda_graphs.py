"""Decode loops captured as CUDA graphs: the port's counterpart of the
JAX package's jitted ``lax.scan`` executables.

A :class:`GraphRunner` holds one ``torch.cuda.CUDAGraph`` per key (for
``MultiLayerNetwork.generate`` a pow2 bucket, batch, dtype and params
version; for ``DecodeEngine`` its decode round). On CPU tensors it runs
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

A kernel wrapper counts a launch when its Python code runs; under
capture that code runs once and launches nothing. The runner takes those
counts back after the capture and adds them again on every replay, so a
wrapper's count stays the number of times its kernel was launched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Iterable

import torch

from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map


def _on_card(leaves) -> bool:
    """Whether a body's input tensors live on a CUDA device."""
    return bool(leaves) and leaves[0].device.type == "cuda"


def _counters() -> list:
    """The launch counters of the kernels a decode graph can hold."""
    return [(attention.flash_attention, "launches"),
            (attention.paged_attention, "launches")]


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
    ``compile_counts`` for these paths); ``captures`` counts every capture
    it has made, so a repeat that captured again shows."""

    def __init__(self, generators: Iterable[torch.Generator] = ()):
        self.generators = tuple(generators)
        self._graphs: Dict[Hashable, _Graph] = {}
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def drop(self) -> None:
        """Forget every graph (their private memory pools go with them)."""
        self._graphs.clear()

    def run(self, key: Hashable, body: Callable, inputs: Any) -> Any:
        """``body(inputs)``: eagerly for CPU tensors; on a CUDA device by
        replaying the graph of ``key``, captured at its first call."""
        leaves = tree_leaves(inputs)
        if not _on_card(leaves):
            return body(inputs)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(body, inputs)
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

    def _capture(self, body: Callable, inputs: Any) -> _Graph:
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
        counters = _counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        with torch.cuda.graph(graph):
            outputs = body(inputs)
        launches = []
        for (obj, attr), n0 in zip(counters, before):
            launches.append(((obj, attr), getattr(obj, attr) - n0))
            setattr(obj, attr, n0)
        self.captures += 1
        return _Graph(graph, inputs, outputs, tuple(launches))
