"""Single-file model serialization, in the JAX package's zip format.

Port of ``deeplearning4j_tpu/util/model_serializer.py``; a zip written
by either package loads in the other::

    model.zip
    ├── type                conf-class marker ("multilayer")
    ├── conf.json           configuration (the wire format)
    ├── params.npz          params, keys "layer␟name" flattened
    └── extras.pkl          updater state + layer state + iteration

Everything in the zip is numpy. :func:`load_numpy_params` is the weight
carry-over: it turns the JAX package's parameters, as numpy arrays, into
the port's tensors.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from typing import Any, Dict

import numpy as np
import torch

_SEP = "␟"  # unit-separator-ish key joiner, never in param names


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(device)
    return tree


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_numpy_params(net, params: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Set ``net``'s parameters from numpy arrays keyed like the JAX
    package's param pytree (``{"0": {"Wq": ...}, ...}``), cast to the
    net's master dtype on its device. Raises on a layer or name the net
    does not have and on a shape mismatch, so a zip from another
    architecture cannot load silently."""
    net.init()
    for si, sub in params.items():
        if si not in net.params:
            raise ValueError(f"layer {si!r} not in the network "
                             f"(layers {sorted(net.params, key=int)})")
        for name, arr in sub.items():
            cur = net.params[si].get(name)
            if cur is None:
                raise ValueError(
                    f"param {si}_{name} not in layer {si} "
                    f"({sorted(net.params[si])})")
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(
                    f"param {si}_{name}: shape {arr.shape} != "
                    f"{tuple(cur.shape)}")
            net.params[si][name] = torch.as_tensor(
                arr, dtype=net._dtype).to(net.device)
    net.params_version += 1


def write_model(net, path: str) -> None:
    """Serialize a MultiLayerNetwork to one zip file, atomically: conf,
    params, and the training state (updater state, layer state,
    iteration) as numpy, so either package resumes training from it."""
    net.init()
    buf = io.BytesIO()
    np.savez(buf, **_flatten(_to_numpy(net.params)))
    extras = {
        "updater_state": _to_numpy(net.updater_state),
        "state": _to_numpy(net.state),
        "iteration": int(net.iteration),
    }
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("type", "multilayer")
        z.writestr("conf.json", net.conf.to_json())
        z.writestr("params.npz", buf.getvalue())
        z.writestr("extras.pkl", pickle.dumps(extras))
    os.replace(tmp, path)


def restore_model(path: str, device="cuda"):
    """Load a model zip into a MultiLayerNetwork on ``device`` (default
    ``"cuda"``; raises when CUDA is absent), with its updater state
    (Adam ``m``/``v``, ...) as tensors on the device and its iteration,
    so ``fit`` resumes where the writer stopped (the ``warmup_cosine``
    position included). ``extras.pkl`` is unpickled, so load only zips
    this package or the JAX package wrote."""
    from deeplearning4j_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        kind = z.read("type").decode()
        conf_json = z.read("conf.json").decode()
        npz = np.load(io.BytesIO(z.read("params.npz")))
        params = _unflatten({k: npz[k] for k in npz.files})
        extras = pickle.loads(z.read("extras.pkl"))
    if kind != "multilayer":
        raise NotImplementedError(
            f"{path} holds a {kind!r} model; the torch package restores "
            "MultiLayerNetwork zips only")
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                            device=dev).init()
    load_numpy_params(net, params)
    net.updater_state = _to_tensors(extras["updater_state"], dev)
    net.state = _to_tensors(extras["state"], dev)
    net.iteration = int(extras["iteration"])
    return net
