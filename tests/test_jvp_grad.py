"""Reverse-mode AD through the JVP attention surface.

Round-1 verdict repro: `jax.grad(sum(attention_jvp(q,k,v)))` raised
"Linearization failed to produce known values..." because the fused Pallas
tangent rule was opaque to transposition. These tests pin the two fixes:

  * attention_jvp — custom_jvp + custom_transpose tangent map: jax.grad of
    primal losses transposes into the flash fp32 backward.
  * attention_value_and_jvp — custom_vjp pair with the second-order
    streamed backward (ops/jvp_bwd): jax.grad of losses containing tO
    (the rCM-distillation training case, reference attention_jvp.py:1-11)
    matches jax.grad of jax.jvp of the fp32 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu import attention_jvp, attention_value_and_jvp
from quantizedattention_tpu.reference import reference_attention, reference_attention_jvp
from tests.conftest import make_qkv


def _tangents(shapes, seed=7):
    keys = jax.random.split(jax.random.key(seed), len(shapes))
    return tuple(jax.random.normal(k, s) for k, s in zip(keys, shapes))


def _close(got, want, rtol=2e-4, atol=2e-4, name=""):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=name
    )


# --------------------------------------------------------------------------
# attention_jvp: reverse mode on the primal (the round-1 failing repro)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_grad_of_primal_matches_oracle(rng, causal):
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=256)

    def loss(q, k, v):
        return jnp.sum(attention_jvp(q, k, v, causal=causal) * do)

    def loss_ref(q, k, v):
        return jnp.sum(reference_attention(q, k, v, causal=causal) * do)

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, w, n in zip(got, want, "qkv"):
        _close(g, w, name=f"d{n}")


def test_grad_of_primal_under_jit(rng):
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=128)
    g = jax.jit(jax.grad(lambda q: jnp.sum(attention_jvp(q, k, v))))(q)
    w = jax.grad(lambda q: jnp.sum(reference_attention(q, k, v)))(q)
    _close(g, w, name="dq under jit")


def test_jvp_path_still_fused(rng):
    """jax.jvp through attention_jvp still matches the oracle pair."""
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=192)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape])
    o, to = jax.jvp(attention_jvp, (q, k, v), (tq, tk, tv))
    o_w, to_w = reference_attention_jvp((q, k, v), (tq, tk, tv))
    _close(o, o_w, name="O")
    _close(to, to_w, rtol=5e-4, atol=5e-4, name="tO")


# --------------------------------------------------------------------------
# attention_value_and_jvp: second-order backward (rCM training)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_pair_forward_matches_oracle(rng, causal):
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape])
    o, to = attention_value_and_jvp(q, k, v, tq, tk, tv, causal=causal)
    o_w, to_w = reference_attention_jvp((q, k, v), (tq, tk, tv), causal=causal)
    _close(o, o_w, name="O")
    _close(to, to_w, rtol=5e-4, atol=5e-4, name="tO")


@pytest.mark.parametrize("causal", [False, True])
def test_grad_of_tangent_loss_matches_oracle(rng, causal):
    """Gradients of a loss on tO — full second-order attention math.

    The oracle is jax.grad of jax.jvp of the fp32 reference: JAX's own
    nested AD on the explicit softmax, which exercises every term of the
    ops/jvp_bwd tile derivation (including the D-hat telescoping).
    """
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape])
    wo = jax.random.normal(jax.random.key(11), q.shape)
    wt = jax.random.normal(jax.random.key(12), q.shape)

    def loss(q, k, v, tq, tk, tv):
        o, to = attention_value_and_jvp(q, k, v, tq, tk, tv, causal=causal)
        return jnp.sum(o * wo) + jnp.sum(to * wt)

    def loss_ref(q, k, v, tq, tk, tv):
        o, to = jax.jvp(
            lambda q_, k_, v_: reference_attention(q_, k_, v_, causal=causal),
            (q, k, v), (tq, tk, tv),
        )
        return jnp.sum(o * wo) + jnp.sum(to * wt)

    got = jax.grad(loss, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    want = jax.grad(loss_ref, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    for g, w, n in zip(got, want, ["q", "k", "v", "tq", "tk", "tv"]):
        _close(g, w, rtol=5e-4, atol=5e-4, name=f"d{n}")


def test_pure_tangent_loss_cross_terms(rng):
    """do=0, loss purely on tO: dq/dk/dv are the Hessian-vector terms."""
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=128)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape], seed=3)

    def loss(q, k, v):
        _, to = attention_value_and_jvp(q, k, v, tq, tk, tv)
        return jnp.sum(to**2)

    def loss_ref(q, k, v):
        _, to = jax.jvp(reference_attention, (q, k, v), (tq, tk, tv))
        return jnp.sum(to**2)

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    assert all(float(jnp.max(jnp.abs(g))) > 0 for g in got), "cross terms vanished"
    for g, w, n in zip(got, want, "qkv"):
        _close(g, w, rtol=5e-4, atol=5e-4, name=f"d{n}")


def test_pair_fast_mode(rng):
    """fast=True (bf16 dot operands, f32 accumulation) stays inside a loose
    envelope of the exact pair — forward and second-order gradients."""
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape], seed=9)
    o_x, to_x = attention_value_and_jvp(q, k, v, tq, tk, tv)
    o_f, to_f = attention_value_and_jvp(q, k, v, tq, tk, tv, fast=True)
    _close(o_f, o_x, rtol=2e-2, atol=2e-2, name="O fast")
    _close(to_f, to_x, rtol=5e-2, atol=5e-2, name="tO fast")

    def loss(fast):
        def f(q_):
            o, to = attention_value_and_jvp(q_, k, v, tq, tk, tv, fast=fast)
            return jnp.sum(to**2) + jnp.sum(o)
        return f

    g_x = jax.grad(loss(False))(q)
    g_f = jax.grad(loss(True))(q)
    _close(g_f, g_x, rtol=5e-2, atol=5e-2, name="dq fast")


def test_cross_lengths_and_padding(rng):
    """Odd q/kv lengths exercise padded-row/column handling in jvp_bwd."""
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=77, kv_tokens=201)
    tq, tk, tv = _tangents([q.shape, k.shape, v.shape], seed=5)

    def loss(*args):
        o, to = attention_value_and_jvp(*args)
        return jnp.sum(jnp.sin(o) + to**2)

    def loss_ref(q, k, v, tq, tk, tv):
        o, to = jax.jvp(reference_attention, (q, k, v), (tq, tk, tv))
        return jnp.sum(jnp.sin(o) + to**2)

    got = jax.grad(loss, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    want = jax.grad(loss_ref, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    for g, w, n in zip(got, want, ["q", "k", "v", "tq", "tk", "tv"]):
        _close(g, w, rtol=1e-3, atol=1e-3, name=f"d{n}")
