"""Analytic SP scaling model (parallel/scaling_model.py): closed-form link
byte/FLOP counts must track the implementations' collective inventories and
the predictions must behave monotonically. Rates are passed explicitly (the
CPU has no row in the device peak table)."""

import pytest

from quantizedattention_tpu.parallel.scaling_model import (
    SPWorkload,
    allgather_cost,
    best_sp_variant,
    device_rates,
    predict_all,
    predict_step,
    ring_cost,
    ulysses_cost,
)

RATES, LINK = device_rates("NVIDIA H100 80GB HBM3")


def w(**kw):
    base = dict(b=2, h=16, h_kv=16, t_local=2048, d=64, n=8, causal=True,
                kind="bf16", train=True)
    base.update(kw)
    return SPWorkload(**base)


def test_ring_bytes_exact():
    # fwd: (n-1) hops x (k, v) bf16; bwd adds n rotations of f32 (dk, dv)
    ww = w(n=4, causal=False)
    shard = ww.b * ww.h_kv * ww.t_local * ww.d
    c = ring_cost(ww)
    assert c.link_fwd == 3 * 2 * shard * 2.0
    assert c.link_bwd == 3 * 2 * shard * 2.0 + 4 * 2 * shard * 4.0
    # non-causal fwd flops: n full hops of 4*b*h*t_loc^2*d
    assert c.flops_fwd == 4 * 4.0 * ww.b * ww.h * ww.t_local**2 * ww.d


def test_int8_ring_moves_fewer_bytes():
    bf = ring_cost(w())
    i8 = ring_cost(w(kind="int8"))
    assert i8.link_fwd < 0.55 * bf.link_fwd  # ~1/2 of bf16 payload + scales


def test_gqa_rides_unrepeated_heads():
    full = ring_cost(w())
    gqa = ring_cost(w(h_kv=4))
    assert gqa.link_fwd == full.link_fwd / 4
    assert gqa.flops_fwd == full.flops_fwd  # compute unchanged


def test_allgather_fwd_bytes_match_ring_fwd():
    # same KV payload must cross the wire either way (fwd)
    assert allgather_cost(w()).link_fwd == ring_cost(w()).link_fwd


def test_causal_imbalance_caps_ring_efficiency():
    # the last rank's ~n-1/2 live hops bound causal ring efficiency near
    # 0.5*(n+1)/(n-1/2) even with infinite bandwidth and no latency
    p = predict_step(w(n=32), "ring", RATES, 1e18, hop_latency_s=0.0)
    assert p.efficiency == pytest.approx(0.5 * 33 / 31.5, rel=1e-3)


def test_ulysses_balanced_causal():
    preds = predict_all(w(n=8), RATES, LINK)
    assert preds["ulysses"].efficiency > preds["ring"].efficiency
    # the compute itself is balanced: with free communication the only
    # loss left is none (at the card's own link rate the all-to-alls are
    # exposed, since Ulysses does not overlap them)
    free = predict_step(w(n=8), "ulysses", RATES, 1e18, collective_latency_s=0.0)
    assert free.efficiency > 0.99


def test_best_variant_respects_divisibility():
    kw = dict(rates=RATES, link_bytes_per_s=LINK)
    assert best_sp_variant(16, 16, 2048, 64, n=8, **kw) == "ulysses"
    # n > h_kv: ulysses impossible -> zigzag/ring/allgather fallback
    got = best_sp_variant(16, 4, 2048, 64, n=8, **kw)
    assert got in ("ring", "allgather", "zigzag")
    assert best_sp_variant(16, 16, 2048, 64, n=8, allow_ulysses=False,
                           allow_zigzag=False, **kw) in ("ring", "allgather")


def test_efficiency_decreases_with_n_for_ring():
    effs = [predict_step(w(n=n), "ring", RATES, LINK).efficiency for n in (2, 4, 8, 16)]
    assert all(a >= b for a, b in zip(effs, effs[1:]))


def test_zigzag_balanced_and_ring_bytes():
    from quantizedattention_tpu.parallel.scaling_model import zigzag_cost

    ww = w(n=16)
    zz, rr = zigzag_cost(ww), ring_cost(ww)
    assert zz.link_fwd == rr.link_fwd and zz.link_bwd == rr.link_bwd
    # balanced: way below the contiguous ring's last-rank-bound flops
    assert zz.flops_fwd < 0.6 * rr.flops_fwd
    p = predict_step(ww, "zigzag", RATES, 1e18, hop_latency_s=0.0)
    assert p.efficiency > 0.99  # no imbalance penalty at infinite bandwidth


def test_best_variant_prefers_balanced_causal():
    # with ulysses disallowed (e.g. too few heads), causal training should
    # pick zigzag over the imbalanced contiguous ring
    got = best_sp_variant(16, 4, 2048, 64, n=8, allow_ulysses=False,
                          rates=RATES, link_bytes_per_s=LINK)
    assert got == "zigzag"


def test_unknown_device_has_no_rates():
    """No row in the peak table: the model raises instead of guessing —
    what attention_sp='auto' meets on a device it has no rates for."""
    with pytest.raises(KeyError, match="no published peaks"):
        device_rates("cpu")
    with pytest.raises(KeyError):
        best_sp_variant(16, 16, 2048, 64, n=8)  # the test backend is the CPU
