"""Recurrent layers: Graves LSTM (peepholes), bidirectional LSTM, GRU,
ImageLSTM, and the per-timestep output layer.

Port of ``deeplearning4j_tpu/nn/layers/recurrent.py``. Where JAX runs
the sequence as one ``lax.scan``, the port runs a Python loop over time
steps (eager, or recorded into a captured CUDA graph by ``fit_scan``),
with the input projection of every step done first as one matmul; the
backward pass is autograd's through the loop.

Parameter packing (``GravesLSTMParamInitializer``):

- "W":  [nIn, 4*nOut]      input->gate weights, gate blocks [i, f, o, g]
- "RW": [nOut, 4*nOut + 3] recurrent weights; the trailing 3 columns are
        the peephole vectors (i, f, o)
- "b":  [4*nOut]           the forget block set to
        ``forget_gate_bias_init`` (default 1.0)

The peepholes: i and f read ``c_prev``, o reads the new ``c``. A masked
step keeps ``(h, c)``. Activations are [N, C, T]; the carried state is
batch-major (``(h, c)`` for the LSTMs, ``h`` for the GRU), the
streaming contract of ``nn/streaming.py``, and a zeroed row is the
initial carry. With ``ring_axis`` (sequence parallelism inside a
``ParallelTrainer(sp_axis=...)`` step) GravesLSTM and GRU run their
recurrence as ``parallel/sequence_parallel.py:sp_scan``: this rank's
time chunk from the carry of the rank before it, exact full BPTT.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn


def _gates(z, n: int):
    return z[..., :n], z[..., n:2 * n], z[..., 2 * n:3 * n], z[..., 3 * n:]


def _scan_maybe_sp(conf, step, carry, n_steps: int):
    """The time recurrence ``step(carry, t) -> (carry, y_t)`` over
    ``n_steps``: a loop, or, when the bean carries ``ring_axis``, a
    distributed ``sp_scan`` over that live axis (this call holds the
    rank's time chunk). Returns (stacked ys, final carry)."""
    ring = getattr(conf.layer, "ring_axis", None)
    if ring:
        from deeplearning4j_tpu_torch.parallel.collectives import (
            ring_axis_group,
        )
        from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
            sp_scan,
        )

        carry, ys = sp_scan(step, carry, list(range(n_steps)),
                            ring_axis_group(ring))
        return ys, carry
    ys = []
    for t in range(n_steps):
        carry, y = step(carry, t)
        ys.append(y)
    return torch.stack(ys), carry


def _keep(mask_t, new, old):
    """A masked step (mask 0) keeps the carried value."""
    if mask_t is None:
        return new
    return torch.where(mask_t[:, None] != 0, new, old)


class LSTMImpl(LayerImplBase):
    """GravesLSTM (reference nn/layers/recurrent/GravesLSTM.java and
    LSTMHelpers.java)."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        n_in, n_out = lc.n_in, lc.n_out
        scheme = conf.resolved("weight_init")
        dist = conf.resolved("dist")
        w = init_weights(gen, (n_in, 4 * n_out), scheme, dist, dtype, device)
        rw = init_weights(gen, (n_out, 4 * n_out + 3), scheme, dist, dtype,
                          device)
        b = torch.zeros((4 * n_out,), dtype=dtype, device=device)
        b[n_out:2 * n_out] = float(getattr(lc, "forget_gate_bias_init",
                                           1.0))
        return {"W": w, "RW": rw, "b": b}

    @classmethod
    def initial_carry(cls, conf, batch: int, dtype=torch.float32,
                      device="cpu"):
        n = conf.layer.n_out
        return (torch.zeros((batch, n), dtype=dtype, device=device),
                torch.zeros((batch, n), dtype=dtype, device=device))

    @classmethod
    def _step(cls, conf, params, carry, xw_t, mask_t):
        """One step from the input projection ``xw_t`` = x_t @ W."""
        n = conf.layer.n_out
        act = cls.activation_of(conf)
        h_prev, c_prev = carry
        rw_g = params["RW"][:, :4 * n]
        peep = params["RW"][:, 4 * n:]  # [nOut, 3]
        z = xw_t + h_prev @ rw_g + params["b"]
        z_i, z_f, z_o, z_g = _gates(z, n)
        i = torch.sigmoid(z_i + c_prev * peep[:, 0])
        f = torch.sigmoid(z_f + c_prev * peep[:, 1])
        g = act(z_g)
        c = f * c_prev + i * g
        o = torch.sigmoid(z_o + c * peep[:, 2])
        h = o * act(c)
        h = _keep(mask_t, h, h_prev)
        c = _keep(mask_t, c, c_prev)
        return (h, c), h

    @classmethod
    def scan_sequence(cls, conf, params, x_tnc, carry, mask_tn=None):
        """Run the sequence [T, N, C]; returns ([T, N, H] outputs, the
        final carry)."""
        xw = x_tnc @ params["W"]                     # every step at once
        return _scan_maybe_sp(
            conf, lambda c, t: cls._step(
                conf, params, c, xw[t],
                None if mask_tn is None else mask_tn[t]),
            carry, x_tnc.shape[0])

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        x_tnc = x.permute(2, 0, 1)                   # [N,C,T] -> [T,N,C]
        carry = state
        if carry is None:
            carry = cls.initial_carry(conf, x.shape[0], x.dtype, x.device)
        mask_tn = None if mask is None else mask.transpose(0, 1)
        hs, carry = cls.scan_sequence(conf, params, x_tnc, carry, mask_tn)
        return hs.permute(1, 2, 0), carry            # [T,N,H] -> [N,H,T]


class BiLSTMImpl(LSTMImpl):
    """Bidirectional Graves LSTM (reference GravesBidirectionalLSTM.java):
    independent forward and backward passes whose outputs are summed;
    it carries no state."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        fwd = LSTMImpl.init(gen, conf, dtype, device)
        bwd = LSTMImpl.init(gen, conf, dtype, device)
        return {"W": fwd["W"], "RW": fwd["RW"], "b": fwd["b"],
                "W_bwd": bwd["W"], "RW_bwd": bwd["RW"], "b_bwd": bwd["b"]}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        if getattr(conf.layer, "ring_axis", None):
            raise ValueError(
                "GravesBidirectionalLSTM cannot run sequence-parallel: "
                "the backward pass needs the globally REVERSED sequence "
                "(a reverse ring); shard unidirectional "
                "GravesLSTM/GRU/attention layers instead")
        x = cls.maybe_dropout(conf, x, train, rng)
        x_tnc = x.permute(2, 0, 1)
        mask_tn = None if mask is None else mask.transpose(0, 1)
        fwd_params = {"W": params["W"], "RW": params["RW"],
                      "b": params["b"]}
        bwd_params = {"W": params["W_bwd"], "RW": params["RW_bwd"],
                      "b": params["b_bwd"]}
        carry0 = LSTMImpl.initial_carry(conf, x.shape[0], x.dtype, x.device)
        hs_f, _ = LSTMImpl.scan_sequence(conf, fwd_params, x_tnc, carry0,
                                         mask_tn)
        x_rev = torch.flip(x_tnc, dims=(0,))
        m_rev = None if mask_tn is None else torch.flip(mask_tn, dims=(0,))
        hs_b, _ = LSTMImpl.scan_sequence(conf, bwd_params, x_rev, carry0,
                                         m_rev)
        hs = hs_f + torch.flip(hs_b, dims=(0,))
        return hs.permute(1, 2, 0), None


class GRUImpl(LayerImplBase):
    """GRU (reference nn/layers/recurrent/GRU.java). Gate blocks [r, u, c]
    packed in "W" [nIn, 3*nOut], "RW" [nOut, 3*nOut], "b" [3*nOut]."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        scheme = conf.resolved("weight_init")
        dist = conf.resolved("dist")
        return {
            "W": init_weights(gen, (lc.n_in, 3 * lc.n_out), scheme, dist,
                              dtype, device),
            "RW": init_weights(gen, (lc.n_out, 3 * lc.n_out), scheme, dist,
                               dtype, device),
            "b": torch.zeros((3 * lc.n_out,), dtype=dtype, device=device),
        }

    @classmethod
    def initial_carry(cls, conf, batch: int, dtype=torch.float32,
                      device="cpu"):
        return torch.zeros((batch, conf.layer.n_out), dtype=dtype,
                           device=device)

    @classmethod
    def _step(cls, conf, params, h_prev, zx, mask_t):
        """One step from ``zx`` = x_t @ W + b."""
        n = conf.layer.n_out
        act = cls.activation_of(conf)
        zh = h_prev @ params["RW"]
        r = torch.sigmoid(zx[..., :n] + zh[..., :n])
        u = torch.sigmoid(zx[..., n:2 * n] + zh[..., n:2 * n])
        c = act(zx[..., 2 * n:] + r * zh[..., 2 * n:])
        h = u * h_prev + (1.0 - u) * c
        return _keep(mask_t, h, h_prev)

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        x_tnc = x.permute(2, 0, 1)
        h = state if state is not None else cls.initial_carry(
            conf, x.shape[0], x.dtype, x.device)
        mask_tn = None if mask is None else mask.transpose(0, 1)
        zx = x_tnc @ params["W"] + params["b"]

        def step(h_prev, t):
            h_new = cls._step(conf, params, h_prev, zx[t],
                              None if mask_tn is None else mask_tn[t])
            return h_new, h_new

        hs, h = _scan_maybe_sp(conf, step, h, x_tnc.shape[0])
        return hs.permute(1, 2, 0), h


class RnnOutputImpl(LayerImplBase):
    """Per-timestep dense + loss activation over [N, C, T]."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        w = init_weights(gen, (lc.n_in, lc.n_out),
                         conf.resolved("weight_init"),
                         conf.resolved("dist"), dtype, device)
        b = torch.full((lc.n_out,), float(conf.resolved("bias_init")),
                       dtype=dtype, device=device)
        return {"W": w, "b": b}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        # [N, C, T] x [C, O] -> [N, O, T]
        ct = torch.promote_types(x.dtype, params["W"].dtype)
        z = (torch.einsum("nct,co->not", x.to(ct), params["W"].to(ct))
             + params["b"][None, :, None])
        out = cls.activation_of(conf)(z)
        if mask is not None:
            out = out * mask[:, None, :]
        return out, state

    @classmethod
    def loss(cls, conf, activations, labels, mask=None):
        return loss_fn(conf.layer.loss_function)(activations, labels, mask)


class ImageLSTMImpl(LayerImplBase):
    """Karpathy NeuralTalk captioning LSTM (reference nn/layers/recurrent/
    ImageLSTM.java, the generation math of its activate()).

    Input [N, C, T]: step 0 is the image embedding, steps 1.. are word
    embeddings. One fused recurrent matrix RW [1 + n_in + H, 4H] gives
    all gates from [1, x_t, h_{t-1}]; gate order i|f|o|g with sigmoid on
    i, f, o and tanh on g; NO forget term at t = 0; h_t = o * tanh(c_t)
    for the tanh activation, else o * c_t. The decoder drops the image
    step: out = h[1:] @ W + b, so the output is [N, n_out, T-1]. With a
    carried state (streaming) every step is a word step and every step
    is decoded."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        h = lc.n_hidden
        scheme = conf.resolved("weight_init")
        dist = conf.resolved("dist")
        return {
            # recurrent weights: rows = [bias, x_t, h_{t-1}]
            "RW": init_weights(gen, (1 + lc.n_in + h, 4 * h), scheme, dist,
                               dtype, device),
            # decoder
            "W": init_weights(gen, (h, lc.n_out), scheme, dist, dtype,
                              device),
            "b": torch.zeros((lc.n_out,), dtype=dtype, device=device),
        }

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        if mask is not None:
            raise ValueError(
                "ImageLSTM does not support feature masks (the decoder "
                "output is time-shifted by the image step)")
        if getattr(conf.layer, "ring_axis", None):
            raise ValueError(
                "ImageLSTM cannot run sequence-parallel: the image step "
                "and time-shifted decoder pin the whole caption to one "
                "device; shard GravesLSTM/GRU/attention layers instead")
        lc = conf.layer
        hdim = lc.n_hidden
        use_tanh = (conf.resolved("activation") or "tanh") == "tanh"
        x = cls.maybe_dropout(conf, x, train, rng)
        x_tnc = x.permute(2, 0, 1)                   # [T, N, C]
        n = x.shape[0]
        if state is None:
            h_prev = torch.zeros((n, hdim), dtype=x.dtype, device=x.device)
            c_prev = torch.zeros_like(h_prev)
        else:
            h_prev, c_prev = state
        ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
        hs = []
        for t in range(x_tnc.shape[0]):
            h_in = torch.cat([ones, x_tnc[t], h_prev], dim=1)
            z = h_in @ params["RW"]
            i = torch.sigmoid(z[:, :hdim])
            f = torch.sigmoid(z[:, hdim:2 * hdim])
            o = torch.sigmoid(z[:, 2 * hdim:3 * hdim])
            g = torch.tanh(z[:, 3 * hdim:])
            forget = 0.0 if (t == 0 and state is None) else 1.0
            c = i * g + forget * f * c_prev
            h_prev = o * (torch.tanh(c) if use_tanh else c)
            c_prev = c
            hs.append(h_prev)
        # decode the word steps only (drop the image step at t = 0)
        # unless the caller streams with a carried state
        hs_dec = hs[1:] if state is None else hs
        hs_dec = (torch.stack(hs_dec) if hs_dec
                  else h_prev.new_zeros((0, n, hdim)))
        out = hs_dec @ params["W"] + params["b"]     # [T', N, n_out]
        return out.permute(1, 2, 0), (h_prev, c_prev)
