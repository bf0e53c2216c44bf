"""Token sampling for the batched decode step.

Port of ``sample_tokens`` from ``deeplearning4j_tpu/serving/sampler.py``:
greedy, temperature and rank top-k ride as per-slot vectors, so rows
with different configs share one call. Random draws come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s, so
sampling matches the JAX package in distribution, never bit for bit.
"""

from __future__ import annotations

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


def sample_tokens(probs, temps, top_ks, gen=None):
    """One token per slot from softmax rows.

    probs: [B, V] class probabilities; temps: [B] float (0 = greedy);
    top_ks: [B] int (V = unfiltered) — both host arrays or tensors
    (host arrays let an all-greedy batch skip sampling without waiting
    for the device); gen: ``torch.Generator`` on ``probs``' device for
    the sampled rows. Greedy rows take ``argmax(probs)``, first index
    on ties, as ``jnp.argmax`` does. Returns int32 [B]."""
    greedy = torch.argmax(probs, dim=1).to(torch.int32)
    temps = torch.as_tensor(temps, dtype=torch.float32)
    if not bool((temps > 0).any()):
        return greedy
    temps = temps.to(probs.device)
    top_ks = torch.as_tensor(top_ks).to(probs.device)
    scaled = _scaled_filtered_logits(probs.float(), temps, top_ks)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=gen)[:, 0].to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)
