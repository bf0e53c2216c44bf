"""Gradient container: ordered map paramName -> gradient tensor.

Port of ``deeplearning4j_tpu/nn/gradient.py``. Keys use the reference's
flat naming "<layerIdx>_<param>" (e.g. "0_W", "2_b") so gradient-check
and updater tests address parameters identically in both packages.
"""

from __future__ import annotations

from typing import Dict

import torch


class Gradient:
    def __init__(self, flat: Dict[str, torch.Tensor] | None = None):
        self._map: Dict[str, torch.Tensor] = dict(flat or {})

    @staticmethod
    def from_tree(tree: Dict[str, Dict[str, torch.Tensor]]) -> "Gradient":
        flat = {}
        for idx in sorted(tree, key=int):
            for name, g in tree[idx].items():
                flat[f"{idx}_{name}"] = g
        return Gradient(flat)

    def to_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, g in self._map.items():
            idx, name = key.split("_", 1)
            tree.setdefault(idx, {})[name] = g
        return tree

    def gradient_for_variable(self, key: str) -> torch.Tensor:
        return self._map[key]

    def set_gradient_for(self, key: str, value: torch.Tensor) -> None:
        self._map[key] = value

    def gradient_map(self) -> Dict[str, torch.Tensor]:
        return dict(self._map)

    def keys(self):
        return self._map.keys()

    def __iter__(self):
        return iter(self._map.items())
