"""Tangent-only attention: tO given precomputed (O, lse), in plain JAX.

Serves reverse-mode AD of the `attention_jvp` API: under `jax.grad`, JAX
linearizes the custom_jvp rule and must TRANSPOSE the tangent map
(tq,tk,tv) -> tO. That map is wrapped in jax.custom_transpose with this
function as the body and ops/flash_bwd as the transpose (the transpose of a
linearization is exactly the VJP). The body must stage no array constants
(jax custom_transpose hoists consts into call args and breaks the
transpose unflatten) — everything array-valued arrives as an argument.

Because lse is known, no online max/rescale chain is needed: p = exp2(s −
lse) is final on first touch, and per q block

    tO = (p ∘ tS) V + p tV − rowsum(p ∘ tS) ∘ O

XLA compiles it; the q axis is processed in blocks (ops/plain.py)
so the [block, kv] intermediates stay bounded at long sequence.

Reference provenance: the tangent math is attention_jvp.py:43-56; the
given-lse restructuring is ours (the reference has no reverse path at all).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.common import qk_scales
from quantizedattention_tpu.ops.plain import (
    block_probs,
    einsum,
    merge_q_blocks,
    q_block_size,
    split_q_blocks,
)
from quantizedattention_tpu.tune.config import BlockConfig


@functools.partial(jax.jit, static_argnames=("causal", "sm_scale", "config", "fast"))
def attention_tangent_fwd(
    q, k, v, o, lse, tq, tk, tv,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
):
    """tO for tangents (tq,tk,tv) at (q,k,v), given fwd residuals (o, lse).

    All inputs [b, h, t, d] except lse [b, h, t]; returns tO f32. `config`
    is accepted for signature parity with the kernels and unused.
    """
    del config
    batch, head, q_tokens, head_dim = q.shape
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    f32 = jnp.float32
    exact = not fast
    k, v, tk, tv = (x.astype(f32) for x in (k, v, tk, tv))
    block = q_block_size(batch, head, k.shape[2], q_tokens)
    blocks = [split_q_blocks(x.astype(f32), block) for x in (q, tq, o, lse)]

    def one(args):
        i, q_b, tq_b, o_b, lse_b = args
        p = block_probs(q_b, k, lse_b, i * block, qk_scale, causal, exact)
        ts = (einsum("bhqd,bhkd->bhqk", tq_b, k, exact)
              + einsum("bhqd,bhkd->bhqk", q_b, tk, exact)) * sm_scale
        h = p * ts
        acc = einsum("bhqk,bhkd->bhqd", h, v, exact) + einsum("bhqk,bhkd->bhqd", p, tv, exact)
        return acc - jnp.sum(h, axis=-1, keepdims=True) * o_b

    n_blocks = blocks[0].shape[0]
    to = jax.lax.map(one, (jnp.arange(n_blocks), *blocks))
    return merge_q_blocks(to, q_tokens)
