"""Greedy layer-wise unsupervised pretraining.

Port of ``pretrain_network``, ``_pretrain_unit``, ``_activate_to`` and
``_make_pretrain_step`` from ``deeplearning4j_tpu/optimize/
pretrainer.py`` (reference MultiLayerNetwork.pretrain :150-226): for
each pretrainable layer in order, feed each batch forward through the
stack below it (inference mode), then run the layer's unsupervised
update (RBM CD-k, the autoencoders' reconstruction gradient) through
its updater, ``num_iterations`` times a batch. The draws come from the
net's pretrain generator on its device (``net._pretrain_generator()``),
seeded once from the net's host generator. ``pretrain_graph`` waits for
ComputationGraph (ROADMAP Queue 1 item 9b).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import PRETRAIN_LAYER_TYPES
from deeplearning4j_tpu_torch.nn.updater.updaters import resolve_lr


def pretrain_network(net, data_iter) -> None:
    """Greedy pretrain of a MultiLayerNetwork's RBM / autoencoder
    layers."""
    for i, (conf, impl) in enumerate(zip(net.conf.confs, net._impls)):
        if not isinstance(conf.layer, PRETRAIN_LAYER_TYPES):
            continue

        def get_input(ds, _i=i):
            x = torch.as_tensor(ds.features, dtype=net._dtype,
                                device=net.device)
            return _activate_to(net, _i, x)

        _pretrain_unit(net, str(i), conf, impl, net._updaters[i],
                       get_input, data_iter)


def _pretrain_unit(net, key_name, conf, impl, upd, get_input,
                   data_iter) -> None:
    """Pretrain one unit whose params live at ``net.params[key_name]``;
    the lr is resolved on the host each update, so conf edits between
    ``pretrain`` calls take effect."""
    gen = net._pretrain_generator()
    data_iter.reset()
    n_iter = max(1, conf.num_iterations)
    for ds in data_iter:
        x_in = get_input(ds)
        for _ in range(n_iter):
            lr = resolve_lr(conf, net.iteration)
            noise = impl.draw_noise(conf, gen, x_in)
            (net.params[key_name], net.updater_state[key_name],
             score) = pretrain_step(impl, conf, upd,
                                    net.params[key_name],
                                    net.updater_state[key_name],
                                    net.iteration, lr, x_in, noise)
            net.params_version += 1
            net.score_value = score
            net.iteration += 1
            for listener in net.listeners:
                listener.iteration_done(net, net.iteration)


def _activate_to(net, layer_idx: int, x):
    """Input activations of layer ``layer_idx`` (reference
    activationFromPrevLayer :199-226), inference mode."""
    if layer_idx == 0:
        pp = net.conf.preprocessor_for(0)
        return pp.pre_process(x, None) if pp is not None else x
    with torch.no_grad():
        acts, _, _ = net._forward_fn(net.params, net.state, x, None, False,
                                     collect=True)
    out = acts[layer_idx - 1]
    pp = net.conf.preprocessor_for(layer_idx)
    return pp.pre_process(out, None) if pp is not None else out


def pretrain_step(impl, conf, upd, layer_params, upd_state, iteration,
                  lr, x, noise):
    """One unsupervised update of one layer: (new params, new updater
    state, score)."""
    score, grads = impl.pretrain_value_and_grad(conf, layer_params, x,
                                                noise)
    with torch.no_grad():
        updates, new_upd = upd.update(grads, upd_state, lr, iteration)
        new_params = {k: p - updates[k] for k, p in layer_params.items()}
    return new_params, new_upd, score
