"""fp32 softmax-attention oracle, with jax.grad / jax.jvp as AD oracles.

Divergence from the reference oracle (documented, intentional — SURVEY.md
§2.3 Q6): the reference's "causal" masks the diagonal too (`q - k > 0`,
attention_bf16.py:461-473). We use standard causal `k <= q`; all of our
kernels and tests agree on this convention.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def reference_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
) -> jnp.ndarray:
    """softmax(Q Kᵀ / sqrt(d)) V in fp32 on [batch, head, tokens, head_dim]."""
    q = q.astype(jnp.float32)
    k = k.astype(jnp.float32)
    v = v.astype(jnp.float32)
    head_dim = q.shape[-1]
    # HIGHEST precision: at default precision a GPU may run f32 products in
    # TF32, which would make the oracle itself inexact.
    hi = jax.lax.Precision.HIGHEST
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=hi) / math.sqrt(head_dim)
    if causal:
        q_tokens, k_tokens = s.shape[-2], s.shape[-1]
        q_ids = jnp.arange(q_tokens)[:, None]
        k_ids = jnp.arange(k_tokens)[None, :]
        s = jnp.where(k_ids <= q_ids, s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v, precision=hi)


def reference_attention_vjp(q, k, v, do, causal: bool = False):
    """Oracle gradients (dq, dk, dv) for cotangent `do`, via jax.vjp."""
    _, vjp_fn = jax.vjp(lambda q_, k_, v_: reference_attention(q_, k_, v_, causal), q, k, v)
    return vjp_fn(do.astype(jnp.float32))


def reference_attention_jvp(primals, tangents, causal: bool = False):
    """Oracle (O, tO) via jax.jvp — the analogue of torch.func.jvp."""
    return jax.jvp(lambda q_, k_, v_: reference_attention(q_, k_, v_, causal), primals, tangents)
