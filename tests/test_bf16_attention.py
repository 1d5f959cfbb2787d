"""Corrected-bf16 flash attention vs the fp32 oracle (fwd + bwd).

Mirrors the reference's test strategy (SURVEY.md §4) but *asserts* tiered
tolerances instead of printing: the reference's published envelope is
915/18,350,080 fwd mismatches at atol 1e-2 (rate 5e-5) and 2,080/18,350,080
v-grad mismatches (rate 1.1e-4) — reference attention_bf16.py:563,719.
"""

import jax
import jax.numpy as jnp
import pytest

from quantizedattention_tpu import flash_attention_bf16, flash_attention_fwd, flash_attention_bwd
from quantizedattention_tpu.reference import reference_attention, reference_attention_vjp
from quantizedattention_tpu.tune.config import BlockConfig
from quantizedattention_tpu.utils.testing import mismatch_report
from tests.conftest import make_qkv

# Reference envelope: fwd 5e-5 mismatch rate, grads 1.1e-4 (BASELINE.md).
# CPU tests use small tensors (~3e4 elements vs the envelope's 1.8e7), so the
# grad bound gets ~3x slack for sample noise; the full-size envelope is
# asserted on the card by chip_smoke.py.
FWD_RATE = 5e-5
GRAD_RATE = 3.5e-4


@pytest.mark.parametrize("causal", [False, True])
def test_forward_bf16(rng, causal):
    q, k, v, _ = make_qkv(rng, batch=2, head=2, q_tokens=256)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report("bf16 fwd", o, want, atol=1e-2)
    assert rep.mismatch_rate <= FWD_RATE, rep
    assert lse.shape == (2, 2, 256)
    assert not bool(jnp.any(jnp.isnan(o)))


@pytest.mark.parametrize("causal", [False, True])
def test_forward_fp32_exact(rng, causal):
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    o, _ = flash_attention_fwd(q, k, v, causal=causal, precision="fp32")
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report("fp32 fwd", o, want, atol=1e-5)
    assert rep.mismatches == 0, rep


def test_forward_uneven_and_cross_lengths(rng):
    """Non-block-multiple and q != kv lengths (the reference only ever tests
    q_tokens == k_tokens — SURVEY.md §2.3 Q5)."""
    q, k, v, _ = make_qkv(rng, q_tokens=192, kv_tokens=320)
    o, _ = flash_attention_fwd(q, k, v)
    want = reference_attention(q, k, v)
    rep = mismatch_report("bf16 fwd uneven", o, want, atol=1e-2)
    assert rep.mismatch_rate <= FWD_RATE, rep


@pytest.mark.parametrize("causal", [False, True])
def test_backward_vs_autodiff_oracle(rng, causal):
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=256)

    def loss(q_, k_, v_):
        return jnp.sum(flash_attention_bf16(q_, k_, v_, causal=causal) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    for name, got, want in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(name, got, want, atol=1e-2)
        assert rep.mismatch_rate <= GRAD_RATE, rep


def test_backward_fp32_residual_path(rng):
    """fp32 fwd + fp32 bwd is near machine-exact against jax.grad."""
    q, k, v, do = make_qkv(rng, batch=1, head=1, q_tokens=256)
    o, lse = flash_attention_fwd(q, k, v, causal=True, precision="fp32")
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=True)
    for name, got, want in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(name, got, want, atol=1e-4)
        assert rep.mismatches == 0, rep


def test_correction_engages_on_tied_logits(rng):
    """Rows with duplicated keys produce tied maxima; the corrected kernel
    must stay finite and match the oracle (the uncorrected failure is a
    training-time drift, so here we check the correction changes nothing
    mathematically and produces no NaN/overflow)."""
    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (1, 1, 128, 64))
    k_half = jax.random.normal(kk, (1, 1, 64, 64)) * 4.0
    k = jnp.concatenate([k_half, k_half], axis=2)  # exact duplicate keys -> ties
    v = jax.random.normal(kv, (1, 1, 128, 64))
    o, _ = flash_attention_fwd(q, k, v, correction="beta")
    want = reference_attention(q, k, v)
    rep = mismatch_report("tied-max corrected", o, want, atol=1e-2)
    assert not bool(jnp.any(jnp.isnan(o)))
    # Amplifying m trades a little one-shot accuracy for training stability
    # (every bf16 P lands below 1.0) — the error stays bounded, not exploding.
    assert rep.mismatch_rate <= 1e-2, rep
    assert rep.max_abs_err <= 0.1, rep


def test_tied_max_corrections_at_extreme_logits(rng):
    """The corrections at the logit scale where they differ (measured study:
    docs/BF16_CORRECTION.md). A row attending 8 EXACTLY tied keys at
    exp2-domain logit ~200: "eps" (ulp bias) keeps every P in (0.99, 1.0)
    and recovers the tie-average output; the reference's "beta" rule
    amplifies the max to ~400, so every P underflows f32, the row's mass
    vanishes, and the output collapses to 0 — the underflow hazard BETA=2
    carries at large logits (the reference's own comment says BETA=8
    overflows, attention_bf16.py:146-147)."""
    from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd

    d, t = 64, 128
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=t)
    u = jnp.ones((d,), jnp.float32) / jnp.sqrt(1.0 * d)
    amp = jnp.sqrt(200.0 * jnp.sqrt(1.0 * d) / 1.4426950408889634)
    q = q.at[0, 0, -1].set(u * amp)
    k = k.at[0, 0, :8].set(jnp.broadcast_to(u * amp, (8, d)))

    want_row = jnp.mean(v[0, 0, :8], axis=0)  # uniform over the exact ties

    o_eps, lse_eps = flash_attention_fwd(q, k, v, correction="eps")
    o_none, _ = flash_attention_fwd(q, k, v, correction="none")
    o_beta, lse_beta = flash_attention_fwd(q, k, v, correction="beta")

    assert float(jnp.max(jnp.abs(o_eps[0, 0, -1] - want_row))) < 2e-2
    assert float(jnp.max(jnp.abs(o_none[0, 0, -1] - want_row))) < 2e-2
    # beta: the amplified max underflows all of the row's probability mass
    assert float(jnp.max(jnp.abs(o_beta[0, 0, -1] - want_row))) > 0.5
    # and its saved lse is off by ~the amplification (backward poison)
    assert float(lse_beta[0, 0, -1] - lse_eps[0, 0, -1]) > 50.0


@pytest.mark.parametrize(
    "kwargs, want_cudnn",
    [
        (dict(), True),
        (dict(bwd_exact=True), False),
        (dict(config=BlockConfig(64, 64)), False),
    ],
    ids=["default", "bwd_exact", "config"],
)
def test_correction_none_cudnn_route(monkeypatch, rng, kwargs, want_cudnn):
    """On a GPU, correction="none" takes cuDNN only when the caller asked
    for neither IEEE-f32 gradients nor a block config; on the CPU never."""
    from quantizedattention_tpu.ops import api

    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=128)
    taken = []
    monkeypatch.setattr(api, "_cudnn_attention", lambda *a: taken.append("cudnn") or q)
    monkeypatch.setattr(api, "_flash_attention_bf16", lambda *a: taken.append("kernel") or q)
    api.flash_attention_bf16(q, k, v, correction="none", **kwargs)
    monkeypatch.setattr(api, "use_interpret_mode", lambda: False)
    api.flash_attention_bf16(q, k, v, correction="none", **kwargs)
    assert taken == ["kernel", "cudnn" if want_cudnn else "kernel"]
