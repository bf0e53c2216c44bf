"""The power of ``chip_smoke.py``'s serving gate, on the CPU.

The gate holds the paged-attention kernel's engine against the plain
gather program's engine: at f32 the greedy ids must be identical on
every request. Here, at a small size (a 2-block, width-64 flagship with
random weights, a few requests past a 64-token window) and with the
plain versions only:

- the plain engine against itself with its score sums reordered (the
  same function, other roundings: what a right kernel is) passes the
  f32 identity check;
- every planted fault ``chip_smoke.py`` plants in the plain engine's
  attention fails it.

The agreement, first-divergence and near-tie helpers are the ones
``chip_smoke.py`` uses (they live there).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import DecodeEngine

agreement = chip_smoke.agreement
first_divergence = chip_smoke.first_divergence
logprob_gap = chip_smoke.logprob_gap
request_agreement = chip_smoke.request_agreement

V, WINDOW, N_GEN = 16, 64, 40
GEOMETRY = dict(paged_kv=True, block_tokens=8, n_slots=2, decode_chunk=4)


@pytest.fixture(scope="module")
def net():
    conf = transformer_lm_flagship(vocab=V, width=64, n_layers=2,
                                   n_heads=4, seed=5)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    return MultiLayerNetwork(conf, device="cpu").init()


def _prompts():
    return chip_smoke.serving_prompts(0, n=3, length=30, vocab=V)


def _ids(net):
    res, _ = chip_smoke.serve_ids(
        DecodeEngine(net, use_flash_paged=False, seed=0, **GEOMETRY),
        _prompts(), N_GEN)
    assert all(len(r.tokens) == N_GEN for r in res)
    return [r.tokens for r in res]


_reordered = chip_smoke.reordered_sums
_patched = chip_smoke.paged_reference_wrapped


@pytest.fixture(scope="module")
def plain_ids(net):
    return _ids(net)


def test_the_workload_slides_past_the_window(plain_ids):
    assert 30 + N_GEN > WINDOW
    assert len(_prompts()) > GEOMETRY["n_slots"]


def test_reordered_score_sums_pass_the_f32_identity_check(net, plain_ids):
    seen = {}

    def capture(ref):
        def fn(*ops, tm):
            seen.setdefault("ops", (ops, tm))
            return ref(*ops, tm=tm)
        return fn

    with _patched(_reordered), _patched(capture):
        got = _ids(net)
    assert got == plain_ids
    assert agreement(got, plain_ids) == [1.0] * len(plain_ids)
    # the reordering is real: the two programs' outputs differ in bits
    ops, tm = seen["ops"]
    ref = attention.paged_attention_reference
    a, b = ref(*ops, tm=tm), _reordered(ref)(*ops, tm=tm)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("fault", sorted(chip_smoke.PLANTED_FAULTS))
def test_a_planted_fault_fails_the_f32_identity_check(net, plain_ids, fault):
    with _patched(chip_smoke.PLANTED_FAULTS[fault]):
        got = _ids(net)
    assert got != plain_ids
    per = agreement(got, plain_ids)
    assert min(per) < 1.0
    at = [first_divergence(a, b) for a, b in zip(got, plain_ids)]
    assert any(i is not None for i in at)


def test_planted_fault_is_undone_after_the_block():
    ref = attention.paged_attention_reference
    with _patched(chip_smoke.PLANTED_FAULTS["scale squared"]):
        assert attention.paged_attention_reference is not ref
    assert attention.paged_attention_reference is ref
    with _patched(None):
        assert attention.paged_attention_reference is ref


def test_agreement_helpers():
    assert request_agreement([1, 2, 3, 4], [1, 2, 0, 4]) == 0.75
    assert request_agreement([1, 2], [1, 2, 3, 4]) == 0.5
    assert request_agreement([], []) == 1.0
    assert agreement([[1, 2], [3]], [[1, 0], [3]]) == [0.5, 1.0]
    with pytest.raises(ValueError, match="requests"):
        agreement([[1]], [])
    assert first_divergence([1, 2, 3], [1, 2, 3]) is None
    assert first_divergence([1, 2, 3], [1, 5, 3]) == 1
    assert first_divergence([1, 2], [1, 2, 3]) == 2


def test_logprob_gap_reads_the_next_token_distribution(net, plain_ids):
    """The gap between a greedy token and any other at the same position
    is >= 0 (the greedy one is the argmax), 0 for the token against
    itself, and antisymmetric."""
    prompt, ids = _prompts()[0], plain_ids[0]
    at = 5
    top = ids[at]
    other = (top + 1) % V
    g = logprob_gap(net, prompt, ids[:at], top, other)
    assert g >= 0.0
    assert logprob_gap(net, prompt, ids[:at], top, top) == 0.0
    assert logprob_gap(net, prompt, ids[:at], other, top) == pytest.approx(-g)


def test_near_tie_report_names_each_divergence(net, plain_ids, capsys):
    """For a run that diverges (a planted fault), one line per diverging
    request with its first divergent position, both tokens and the gap,
    which is >= 0 where the first run's token is the net's own greedy
    pick; nothing for identical runs."""
    with _patched(chip_smoke.PLANTED_FAULTS["scale squared"]):
        other = _ids(net)
    chip_smoke.near_tie_report(net, _prompts(), plain_ids, plain_ids, "same")
    assert capsys.readouterr().out == ""
    chip_smoke.near_tie_report(net, _prompts(), plain_ids, other, "fault")
    lines = capsys.readouterr().out.splitlines()
    diverging = [r for r, (a, b) in enumerate(zip(plain_ids, other))
                 if a != b]
    assert len(lines) == len(diverging) > 0
    for line, r in zip(lines, diverging):
        at = first_divergence(plain_ids[r], other[r])
        assert line.startswith(f"  fault request {r}: first divergence at "
                               f"token {at}: {plain_ids[r][at]} vs "
                               f"{other[r][at]}")
        assert float(line.rsplit(" ", 1)[1]) >= 0.0
