"""The paged decode attention of the PyTorch port against the JAX
package.

The port's plain version (``paged_attention_reference``, which CPU
tensors take through the ``paged_attention`` wrapper) is held against
both JAX paths of ``AttentionImpl._paged_attend``: the XLA gather
program (``use_flash_paged=False``) and the Pallas kernel in interpret
mode, as ``tests/test_serving_tp.py`` runs it. Tolerance 2e-5, the bar
of JAX's own interpret-mode test. The pool the port scatters into in
place must equal the pool JAX returns, exactly.

The CUDA kernel itself cannot run here (this suite imports JAX, which
the card's machine lacks): ``chip_smoke.py`` holds it against the plain
version on the card at the serving path's shapes; the wrapper's
argument checks run here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.attention import (
    AttentionImpl as JAttn,
    MultiHeadSelfAttention as JBean,
)
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers.attention import (
    AttentionImpl as TAttn,
    MultiHeadSelfAttention as TBean,
    paged_attention,
    paged_attention_reference,
)

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, DH, BT, TM, S_RING, NB = 4, 2, 8, 4, 16, 8, 24


def _case(t, masked, seed=0):
    """Four rows over one pool: row 0 ordinary; row 1 with a raised
    floor past a slid window; row 2 idle (nothing mapped: no valid
    key); row 3 with an unmapped and a stale ring slot. Pool block 0
    (the placeholder invalid entries read) and a free block hold NaN,
    and row 0's partly written tail block holds NaN past the span."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    k = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    v = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    pk = rng.normal(size=(NB, BT, H, DH)).astype(np.float32)
    pv = rng.normal(size=(NB, BT, H, DH)).astype(np.float32)
    table = np.full((B, S_RING), -1, np.int32)
    base = np.full((B, S_RING), -1, np.int32)
    floor = np.zeros(B, np.int32)
    filled = np.zeros(B, np.int32)
    free = 1 + np.random.default_rng(seed + 1).permutation(NB - 1)
    nxt = iter(free.tolist())

    def map_blocks(row, gs):
        for g in gs:
            table[row, g % S_RING] = next(nxt)
            base[row, g % S_RING] = g * BT

    filled[0] = 9
    map_blocks(0, range(0, 4))           # tail block g=2 partly written
    filled[1], floor[1] = 22, 13
    map_blocks(1, range(3, 7))
    filled[3] = 14
    map_blocks(3, range(0, 5))
    table[3, 1 % S_RING] = -1            # unmapped ring slot
    base[3, 2 % S_RING] = (2 + S_RING) * BT   # stale ring slot
    used = set(table[table >= 0].tolist())
    poisoned = [0, next(b for b in free.tolist() if b not in used)]
    for blk in poisoned:
        pk[blk] = np.nan
        pv[blk] = np.nan
    tail = table[0, 2]
    pk[tail, 1 + t:] = np.nan            # positions >= 9 + t: unwritten
    pv[tail, 1 + t:] = np.nan
    mask = None
    if masked:
        mask = np.zeros((B, t), np.float32)
        for row, n in enumerate((t, t - 1, 0, 2)):
            mask[row, :n] = 1.0
    return dict(q=q, k=k, v=v, pk=pk, pv=pv, table=table, base=base,
                floor=floor, filled=filled, mask=mask)


def _jax_attend(c, toggle):
    lc = JBean(n_in=H * DH, n_out=H * DH, n_heads=H, stream_max_t=TM,
               use_flash_paged=toggle)
    cache = {key: jnp.asarray(c[key]) for key in
             ("pk", "pv", "table", "base", "floor", "filled")}
    mask = None if c["mask"] is None else jnp.asarray(c["mask"])
    o, st = JAttn._paged_attend(lc, jnp.asarray(c["q"]),
                                jnp.asarray(c["k"]), jnp.asarray(c["v"]),
                                cache, mask)
    return np.asarray(o), {k: np.asarray(a) for k, a in st.items()}


def _port_attend(c, toggle=None):
    lc = TBean(n_in=H * DH, n_out=H * DH, n_heads=H, stream_max_t=TM,
               use_flash_paged=toggle)
    cache = {key: torch.as_tensor(c[key].copy()) for key in
             ("pk", "pv", "table", "base", "floor", "filled")}
    mask = None if c["mask"] is None else torch.as_tensor(c["mask"])
    o, st = TAttn._paged_attend(lc, torch.as_tensor(c["q"]),
                                torch.as_tensor(c["k"]),
                                torch.as_tensor(c["v"]), cache, mask)
    assert st["pk"] is cache["pk"] and st["pv"] is cache["pv"], (
        "the port scatters into the pool in place")
    return o.numpy(), {k: a.numpy() for k, a in st.items()}


CASES = [(1, False), (4, False), (4, True)]


@pytest.mark.parametrize("t,masked", CASES)
def test_plain_version_matches_the_gather_program(t, masked):
    c = _case(t, masked)
    want, jst = _jax_attend(c, False)
    got, tst = _port_attend(c)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(tst["filled"], jst["filled"])
    # the in-place scatter leaves the pool JAX returns (NaN where poisoned)
    np.testing.assert_array_equal(tst["pk"], jst["pk"])
    np.testing.assert_array_equal(tst["pv"], jst["pv"])


@pytest.mark.parametrize("t,masked", CASES)
def test_plain_version_matches_the_interpreted_pallas_kernel(t, masked):
    c = _case(t, masked)
    want, _ = _jax_attend(c, "interpret")
    got, _ = _port_attend(c)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_row_with_no_valid_key_is_exactly_zero(t):
    got, _ = _port_attend(_case(t, False))
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("toggle", [False, "interpret", None])
def test_every_cpu_toggle_takes_the_plain_version(toggle):
    c = _case(4, True)
    before = paged_attention.launches
    got, _ = _port_attend(c, toggle)
    ref, _ = _port_attend(c, False)
    np.testing.assert_array_equal(got, ref)
    assert paged_attention.launches == before


def test_dispatch_rule():
    cpu = torch.zeros(1)
    assert tatt._should_use_flash_paged(None, cpu)
    assert not tatt._should_use_flash_paged(False, cpu)
    assert not tatt._should_use_flash_paged("interpret", cpu)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._should_use_flash_paged(True, cpu)
    with pytest.raises(ValueError, match="expected"):
        tatt._should_use_flash_paged("auto", cpu)


def _kernel_ops(t=1, dh=128, bt=16, q_dtype=torch.float32,
                kv_dtype=torch.float32, device="cpu"):
    b, h, nb, ntab = 2, 2, 8, 4
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros(b, h, t, dh, dtype=q_dtype, device=device),
            torch.zeros(nb, bt, h, dh, dtype=kv_dtype, device=device),
            torch.zeros(nb, bt, h, dh, dtype=kv_dtype, device=device),
            torch.zeros(b, ntab, **i32), torch.zeros(b, ntab, **i32),
            torch.zeros(b, **i32), torch.zeros(b, **i32),
            torch.zeros(b, **i32), torch.ones(b, **i32))


@pytest.mark.parametrize("kw,match", [
    (dict(dh=32), "head dim"),
    (dict(bt=12), "power of two"),
    (dict(bt=128), "power of two"),
    (dict(q_dtype=torch.float16), "q dtype"),
    (dict(kv_dtype=torch.float64), "pool dtypes"),
])
def test_kernel_argument_checks_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tatt._check_kernel_args(*_kernel_ops(**kw))


def test_kernel_argument_checks_accept_the_serving_shapes():
    for q_dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128):
            tatt._check_kernel_args(*_kernel_ops(t=4, dh=dh,
                                                 q_dtype=q_dtype))
    ops = list(_kernel_ops())
    ops[3] = ops[3].long()
    with pytest.raises(ValueError, match="int32"):
        tatt._check_kernel_args(*ops)
    ops = list(_kernel_ops())
    ops[1] = ops[1].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tatt._check_kernel_args(*ops)
