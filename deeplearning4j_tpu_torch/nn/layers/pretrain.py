"""Pretrainable layers: RBM (contrastive divergence), the denoising
AutoEncoder and the RecursiveAutoEncoder.

Port of ``deeplearning4j_tpu/nn/layers/pretrain.py`` (reference
nn/layers/feedforward/rbm/RBM.java: CD-k :110-178, BINARY / GAUSSIAN /
RECTIFIED / SOFTMAX units; autoencoder/AutoEncoder.java,
autoencoder/recursive/RecursiveAutoEncoder.java).

The random draws are inputs: ``draw_noise(conf, gen, x)`` draws, from
an explicit ``torch.Generator``, every uniform and normal tensor one
update reads, and ``pretrain_value_and_grad(conf, params, x, noise)``
consumes them. A Bernoulli sample of ``p`` is ``u < p`` with ``u``
uniform in [0, 1), as ``jax.random.bernoulli`` is, so feeding the draws
JAX's key chain made gives JAX's samples.

CD-k is not the gradient of a tractable loss, so ``RBMImpl`` returns
its gradient estimate directly; the autoencoders differentiate their
reconstruction loss with autograd.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import HiddenUnit, VisibleUnit
from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _normal(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _visible_params(gen, conf, dtype, device) -> dict:
    lc = conf.layer
    w = init_weights(gen, (lc.n_in, lc.n_out), conf.resolved("weight_init"),
                     conf.resolved("dist"), dtype, device)
    b = torch.full((lc.n_out,), float(conf.resolved("bias_init")),
                   dtype=dtype, device=device)
    vb = torch.full((lc.n_in,), float(lc.visible_bias_init), dtype=dtype,
                    device=device)
    return {"W": w, "b": b, "vb": vb}


def _with_grads(loss, params):
    """(score, grads) of ``loss(params)`` by autograd at requires-grad
    aliases of ``params``."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        score = loss(leaves)
        grads = torch.autograd.grad(score, list(leaves.values()))
    return score.detach(), dict(zip(leaves, grads))


class RBMImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        return _visible_params(gen, conf, dtype, device)

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        z = x @ params["W"] + params["b"]
        return cls.activation_of(conf)(z), state

    # ------------------------------------------------------------------
    # CD-k machinery
    # ------------------------------------------------------------------
    @classmethod
    def _hidden_mean(cls, conf, params, v):
        z = v @ params["W"] + params["b"]
        hu = conf.layer.hidden_unit
        if hu == HiddenUnit.BINARY:
            return torch.sigmoid(z)
        if hu == HiddenUnit.GAUSSIAN:
            return z
        if hu == HiddenUnit.RECTIFIED:
            return torch.relu(z)
        if hu == HiddenUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(hu)

    @classmethod
    def _sample_hidden(cls, conf, params, v, noise):
        mean = cls._hidden_mean(conf, params, v)
        hu = conf.layer.hidden_unit
        if hu == HiddenUnit.BINARY:
            return mean, (noise < mean).to(v.dtype)
        if hu == HiddenUnit.GAUSSIAN:
            return mean, mean + noise
        if hu == HiddenUnit.RECTIFIED:
            # NReLU sampling: max(0, mean + N(0, sigmoid(mean)))
            return mean, torch.relu(
                mean + noise * torch.sqrt(torch.sigmoid(mean) + 1e-8))
        if hu == HiddenUnit.SOFTMAX:
            return mean, mean
        raise ValueError(hu)

    @classmethod
    def _visible_mean(cls, conf, params, h):
        z = h @ params["W"].T + params["vb"]
        vu = conf.layer.visible_unit
        if vu == VisibleUnit.BINARY:
            return torch.sigmoid(z)
        if vu in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return z
        if vu == VisibleUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(vu)

    @classmethod
    def _sample_visible(cls, conf, params, h, noise):
        mean = cls._visible_mean(conf, params, h)
        vu = conf.layer.visible_unit
        if vu == VisibleUnit.BINARY:
            return mean, (noise < mean).to(h.dtype)
        if vu == VisibleUnit.GAUSSIAN:
            return mean, mean + noise
        return mean, mean

    @staticmethod
    def _hidden_draw(conf, gen, shape, like):
        hu = conf.layer.hidden_unit
        if hu == HiddenUnit.BINARY:
            return _uniform(gen, shape, like)
        if hu in (HiddenUnit.GAUSSIAN, HiddenUnit.RECTIFIED):
            return _normal(gen, shape, like)
        return None

    @staticmethod
    def _visible_draw(conf, gen, shape, like):
        vu = conf.layer.visible_unit
        if vu == VisibleUnit.BINARY:
            return _uniform(gen, shape, like)
        if vu == VisibleUnit.GAUSSIAN:
            return _normal(gen, shape, like)
        return None

    @classmethod
    def draw_noise(cls, conf, gen, x) -> dict:
        """The draws of one CD-k update on ``x`` [N, n_in]: ``"h0"`` for
        the positive phase's hidden sample, then per Gibbs step ``"v"``
        and ``"h"`` (lists of k). Uniform for binary units, normal for
        gaussian and rectified ones, None where a unit kind samples its
        mean."""
        lc = conf.layer
        k = max(1, lc.k)
        n = x.shape[0]
        h_shape, v_shape = (n, lc.n_out), (n, lc.n_in)
        noise = {"h0": cls._hidden_draw(conf, gen, h_shape, x),
                 "v": [], "h": []}
        for _ in range(k):
            noise["v"].append(cls._visible_draw(conf, gen, v_shape, x))
            noise["h"].append(cls._hidden_draw(conf, gen, h_shape, x))
        return noise

    @classmethod
    def pretrain_value_and_grad(cls, conf, params, x, noise):
        """One CD-k estimate from the draws ``noise``
        (:meth:`draw_noise`): (score, grads) with grads oriented for
        gradient DESCENT (params -= lr * grad), the reference's sign
        handling in RBM.computeGradientAndScore."""
        lc = conf.layer
        k = max(1, lc.k)
        n = x.shape[0]
        h0_mean, h_sample = cls._sample_hidden(conf, params, x, noise["h0"])
        for step in range(k):
            vk_mean, vk = cls._sample_visible(conf, params, h_sample,
                                              noise["v"][step])
            hk_mean, h_sample = cls._sample_hidden(conf, params, vk,
                                                   noise["h"][step])
        w_grad = -(x.T @ h0_mean - vk.T @ hk_mean) / n
        hb_grad = -(h0_mean - hk_mean).mean(dim=0)
        vb_grad = -(x - vk).mean(dim=0)
        score = loss_fn(lc.loss_function)(vk_mean, x)
        return score, {"W": w_grad, "b": hb_grad, "vb": vb_grad}


class AutoEncoderImpl(LayerImplBase):
    """Denoising autoencoder with tied decode weights (reference
    AutoEncoder.java; corruption by a Bernoulli keep-mask of
    1 - ``corruption_level``)."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        return _visible_params(gen, conf, dtype, device)

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        z = x @ params["W"] + params["b"]
        return cls.activation_of(conf)(z), state

    @classmethod
    def draw_noise(cls, conf, gen, x):
        """The uniform draw of the corruption mask, or None."""
        if conf.layer.corruption_level > 0.0 and gen is not None:
            return _uniform(gen, tuple(x.shape), x)
        return None

    @classmethod
    def pretrain_loss(cls, conf, params, x, noise):
        lc = conf.layer
        act = cls.activation_of(conf)
        corrupted = x
        if lc.corruption_level > 0.0 and noise is not None:
            keep = noise < 1.0 - lc.corruption_level
            corrupted = x * keep.to(x.dtype)
        h = act(corrupted @ params["W"] + params["b"])
        recon = act(h @ params["W"].T + params["vb"])
        score = loss_fn(lc.loss_function)(recon, x)
        if getattr(lc, "sparsity", 0.0):
            rho, rho_hat = lc.sparsity, h.mean(dim=0)
            eps = 1e-7
            kl = (rho * torch.log(rho / (rho_hat + eps))
                  + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat + eps)))
            score = score + kl.sum()
        return score

    @classmethod
    def pretrain_value_and_grad(cls, conf, params, x, noise):
        return _with_grads(
            lambda p: cls.pretrain_loss(conf, p, x, noise), params)


class RecursiveAutoEncoderImpl(LayerImplBase):
    """Recursive autoencoder (reference RecursiveAutoEncoder.java and
    RecursiveParamInitializer.java: UNTIED encoder W [nIn, nOut], decoder
    U [nOut, nIn], hidden bias b, visible bias vb).

    The reference folds the input rows greedily; row j's reconstruction
    error appears in every fold step whose stack holds it, the step of
    size m contributing (1/m)·Σ_{j<m} err_j, so the score is Σ_j w_j·err_j
    with tail-harmonic weights w_j = Σ_{m=max(j+1,2)}^{R} 1/m: one encoder
    and one decoder matmul over all rows. Gradients are autograd's of
    that score."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        scheme = conf.resolved("weight_init")
        dist = conf.resolved("dist")
        w = init_weights(gen, (lc.n_in, lc.n_out), scheme, dist, dtype,
                         device)
        u = init_weights(gen, (lc.n_out, lc.n_in), scheme, dist, dtype,
                         device)
        b = torch.full((lc.n_out,), float(conf.resolved("bias_init")),
                       dtype=dtype, device=device)
        vb = torch.full((lc.n_in,), float(lc.visible_bias_init),
                        dtype=dtype, device=device)
        return {"W": w, "U": u, "b": b, "vb": vb}

    @classmethod
    def encode(cls, conf, params, x):
        return cls.activation_of(conf)(x @ params["W"] + params["b"])

    @classmethod
    def decode(cls, conf, params, y):
        return cls.activation_of(conf)(y @ params["U"] + params["vb"])

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        return cls.encode(conf, params, x), state

    @classmethod
    def draw_noise(cls, conf, gen, x):
        return None

    @classmethod
    def pretrain_loss(cls, conf, params, x, noise=None):
        rows = x.shape[0]
        if rows < 2:
            raise ValueError("RecursiveAutoEncoder needs >= 2 rows to fold")
        z = cls.decode(conf, params, cls.encode(conf, params, x))
        err = 0.5 * ((z - x) ** 2).mean(dim=-1)       # [R] per row
        # w_j = sum_{m=max(j+1,2)}^{R} 1/m (tail harmonic numbers)
        m = torch.arange(rows + 1, dtype=x.dtype, device=x.device)
        inv = torch.where(m >= 2, 1.0 / torch.clamp(m, min=1),
                          torch.zeros_like(m))
        tail = torch.flip(torch.cumsum(torch.flip(inv, (0,)), 0), (0,))
        lo = torch.clamp(torch.arange(rows, device=x.device) + 1, min=2)
        return (tail[lo] * err).sum()

    @classmethod
    def pretrain_value_and_grad(cls, conf, params, x, noise=None):
        return _with_grads(
            lambda p: cls.pretrain_loss(conf, p, x, noise), params)
