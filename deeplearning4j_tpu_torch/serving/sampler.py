"""Token sampling for the batched decode step, and the acceptance
rules of speculative decoding.

Port of ``deeplearning4j_tpu/serving/sampler.py``: greedy, temperature
and rank top-k ride as per-slot vectors, so rows with different configs
share one call. :func:`greedy_acceptance` is the equality rule (bit
parity with plain greedy decode); :func:`stochastic_acceptance` the
rejection-sampling rule (Leviathan et al.) that lets sampled rows ride
the same verify pass, with :func:`residual_sample` drawing the token
after a rejection, so emitted tokens follow the target's sampling
distribution. None of them reads a value back to the host: the engine's
verify pass runs them inside a captured CUDA graph. Random draws come
from an explicit ``torch.Generator``; they differ from ``jax.random``'s,
so sampling matches the JAX package in distribution, never bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# probability floor before the log: the output layer emits exact zeros
# for impossible classes under masking
_PROB_FLOOR = 1e-30


def _scaled_filtered_logits(probs, temps, top_ks):
    """Temperature-scaled, rank-top-k-filtered log-probabilities. Rank
    based (a stable sort breaks ties by class index, the winner argmax
    picks), so ties at the k-th value never let more than k classes
    through."""
    logits = torch.log(torch.clamp(probs, min=_PROB_FLOOR))
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    filtered = torch.where(ranks < top_ks[..., None], logits,
                           torch.full_like(logits, -float("inf")))
    return filtered / torch.clamp(temps, min=1e-6)[..., None]


def _draw(p, gen):
    """One class per row of the distributions ``p`` [B, V]
    (``torch.multinomial``). A row that is not finite (a slot whose K/V
    a fault poisoned) draws from the uniform distribution instead:
    ``multinomial`` asserts on the device when any row holds a NaN, and
    that assert would end the process, not the one request. Finite rows
    and the generator's draws are untouched. int32 [B]."""
    ok = torch.isfinite(p).all(dim=-1, keepdim=True)
    p = torch.where(ok, p, torch.ones_like(p))
    return torch.multinomial(p, 1, generator=gen)[:, 0].to(torch.int32)


def sample_tokens(probs, temps, top_ks, gen=None):
    """One token per slot from softmax rows.

    probs: [B, V] class probabilities; temps: [B] float (0 = greedy);
    top_ks: [B] int (V = unfiltered); gen: ``torch.Generator`` on
    ``probs``' device for the sampled rows. Greedy rows take
    ``argmax(probs)``, first index on ties, as ``jnp.argmax`` does.
    Returns int32 [B].

    ``temps`` and ``top_ks`` as host arrays let an all-greedy batch skip
    the sampled branch without waiting for the device. As tensors (the
    captured decode round's static buffers) the sampled branch always
    runs, as in JAX's traced sampler, so a graph captured on a greedy
    batch still samples the rows that ask for it (``torch.multinomial``
    reads nothing back to the host, so it captures into a graph)."""
    greedy = torch.argmax(probs, dim=1).to(torch.int32)
    if not isinstance(temps, torch.Tensor) and not (
            np.asarray(temps) > 0).any():
        return greedy
    temps = torch.as_tensor(temps, dtype=torch.float32).to(probs.device)
    top_ks = torch.as_tensor(top_ks).to(probs.device)
    scaled = _scaled_filtered_logits(probs.float(), temps, top_ks)
    sampled = _draw(torch.softmax(scaled, dim=-1), gen)
    return torch.where(temps > 0, sampled, greedy)


def _prefix_count(ok):
    """Length of each row's leading run of True in ``ok`` [B, W]: the
    cumulative-product prefix reduction (one rejection invalidates
    every later position). int32 [B]."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def greedy_acceptance(targets, draft, lens):
    """Accepted-prefix lengths under the GREEDY rule: draft token ``i``
    is accepted iff it equals the model's argmax target at its position
    AND every earlier draft token was accepted.

    targets: [B, W] int — argmax next-token id at each draft position
    (position ``i`` scores context + draft[:i]); draft: [B, W] int,
    right-padded; lens: [B] int — valid draft length per row (pad never
    accepts). Returns int32 [B] in ``[0, lens]``: accepted tokens are
    by construction exactly the tokens plain greedy decode emits."""
    w = draft.shape[1]
    pos = torch.arange(w, device=draft.device)
    ok = (draft == targets) & (pos[None, :] < lens[:, None])
    return _prefix_count(ok)


def draft_probabilities(probs, draft, temps, top_ks):
    """``p_tau(draft_i)``: the probability of each drafted token under
    the row's temperature-scaled, rank-top-k-filtered target (the
    distribution :func:`sample_tokens` draws from). probs: [B, W, V];
    draft: [B, W]; temps/top_ks: [B]. float32 [B, W]."""
    b, w, _ = probs.shape
    scaled = _scaled_filtered_logits(
        probs.float(), temps[:, None].expand(b, w),
        top_ks[:, None].expand(b, w))
    p_tau = torch.softmax(scaled, dim=-1)
    return torch.gather(p_tau, 2, draft.long()[..., None])[..., 0]


def stochastic_acceptance(probs, draft, lens, temps, top_ks, gen=None):
    """Accepted-prefix lengths under rejection-sampling acceptance
    (Leviathan et al. 2023): draft token ``i`` is accepted with
    probability ``min(1, p(x)/q(x))``. The n-gram drafter is
    deterministic — ``q`` is a point mass on the drafted token — so the
    rule is "accept with probability ``p_tau(draft_i)``"
    (:func:`draft_probabilities`).

    probs: [B, W, V] target softmax at each draft position; draft:
    [B, W] int, right-padded; lens: [B] valid lengths; temps/top_ks:
    [B] per-slot config, greedy rows (``temps == 0``) keeping the
    equality rule; gen: the ``torch.Generator`` of the uniform draws
    (one per position, drawn for every row). Returns int32 [B] in
    ``[0, lens]`` by the same prefix reduction as
    :func:`greedy_acceptance`. With :func:`residual_sample` at the
    first rejected position, emitted tokens are distributed exactly as
    if the target had sampled them one by one."""
    b, w, _ = probs.shape
    greedy_ok = draft == torch.argmax(probs, dim=-1).to(draft.dtype)
    p_draft = draft_probabilities(probs, draft, temps, top_ks)
    u = torch.rand((b, w), generator=gen, device=probs.device)
    ok = torch.where((temps > 0)[:, None], u < p_draft, greedy_ok)
    ok = ok & (torch.arange(w, device=probs.device)[None, :]
               < lens[:, None])
    return _prefix_count(ok)


def residual_sample(probs, ban_tok, do_ban, temps, top_ks, gen=None):
    """The token after a verify pass's accepted prefix: like
    :func:`sample_tokens`, but rows with ``do_ban`` exclude ``ban_tok``
    from the support (renormalized) — the residual distribution of a
    rejected point-mass draft. The ban comes AFTER the rank top-k
    filter: re-ranking after it would admit the (k+1)-th class, which
    plain sampling never emits. (Under ``top_k == 1`` a drafted argmax
    always accepts, so a ban never empties a row.)

    probs: [B, V]; ban_tok: [B] int; do_ban: [B] bool; temps, top_ks:
    [B] tensors; gen as in :func:`sample_tokens`. Returns int32 [B];
    greedy rows return argmax whatever the ban (a greedy rejection
    means the model's own argmax is the correction token)."""
    greedy = torch.argmax(probs, dim=1).to(torch.int32)
    scaled = _scaled_filtered_logits(probs.float(), temps, top_ks)
    v = probs.shape[-1]
    ban = do_ban[:, None] & (torch.arange(v, device=probs.device)[None, :]
                             == ban_tok.long()[:, None])
    scaled = torch.where(ban, torch.full_like(scaled, -float("inf")),
                         scaled)
    sampled = _draw(torch.softmax(scaled, dim=-1), gen)
    return torch.where(temps > 0, sampled, greedy)
