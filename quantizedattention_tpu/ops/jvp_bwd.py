"""Second-order (reverse-over-forward) backward for JVP attention.

The reference's JVP kernel is forward-only (attention_jvp.py:24 — consumed
by `torch.func.jvp`), but its stated purpose is rCM distillation
(attention_jvp.py:1-11), which *trains* by backpropagating a loss that
contains the tangent output tO. That requires the VJP of the map

    (q, k, v, tq, tk, tv)  ->  (O, tO)

i.e. second-order derivatives of attention contracted against the tangent
direction. No counterpart exists in the reference; this module derives the
tile math from scratch. It runs as plain JAX that XLA compiles: a scan over
q blocks (each [block, kv] tile set is bounded in memory) that emits dQ/dtQ
per block and accumulates dK/dV/dtK/dtV across blocks. About seven live f32
[block_q, block_kv] tiles per step would not fit a Hopper block's registers
without a redesign, so there is no hand-written kernel for it.

Tile math (p: softmax probabilities, exp2-domain recompute; tS, mu natural):

    p    = exp2(q·qk_scale Kᵀ − lse)
    tS   = (tQ Kᵀ + Q tKᵀ)·sm_scale
    tP   = p ∘ (tS − mu)                       mu = rowsum(p ∘ tS)  [residual]
    tP̄   = tŌ Vᵀ
    p̄    = Ō Vᵀ + tŌ tVᵀ + tP̄ ∘ (tS − mu) − c·tS
    dS   = p ∘ (p̄ − D̂)                         softmax VJP, natural domain
    tS̄   = p ∘ (tP̄ − c)

with per-row scalars precomputed OUTSIDE the kernels (each is a rowsum over
the full row, so it must close before any tile math uses it):

    D  = rowsum(Ō ∘ O)            classic FA2 row term
    c  = rowsum(tŌ ∘ O)           = rowsum(tP̄ ∘ p) after the PV contraction
    D̂  = D + rowsum(tŌ ∘ tO) − c·mu

(The rowsum(p ∘ tŌ tVᵀ) and rowsum(p ∘ tP̄ ∘ (tS−mu)) terms that appear in
rowsum(p̄ ∘ p) telescope through B = p·tV and tP·V = tO − B, and B cancels —
leaving D̂ expressible from forward residuals alone. Derivation checked
against jax.grad-of-jax.jvp of the fp32 oracle in tests/test_jvp_grad.py.)

Gradients:

    dV  = pᵀ Ō + tPᵀ tŌ                 dtV = pᵀ tŌ
    dK  = (dSᵀ Q + tS̄ᵀ tQ)·sm_scale     dtK = tS̄ᵀ Q · sm_scale
    dQ  = (dS K + tS̄ tK)·sm_scale       dtQ = tS̄ K · sm_scale

Setting tŌ=0 collapses everything to the classic FA2 backward; setting Ō=0
gives the pure tangent-loss gradients (the rCM case).
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
def attention_jvp_bwd(
    q, k, v, tq, tk, tv, o, to, lse, mu, do, dto,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
):
    """VJP of (q,k,v,tq,tk,tv) -> (O,tO). Returns (dq, dk, dv, dtq, dtk, dtv).

    lse/mu: [b,h,t] residuals from attention_jvp_fwd. do/dto: cotangents of
    (O, tO). fast=True rounds the dot operands to bf16 (f32 accumulation)
    instead of IEEE f32. `config` is accepted for signature parity and
    unused.
    """
    del config
    batch, head, q_tokens, head_dim = q.shape
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    f32 = jnp.float32
    exact = not fast
    k, v, tk, tv = (x.astype(f32) for x in (k, v, tk, tv))
    q, tq, do, dto, o, to = (x.astype(f32) for x in (q, tq, do, dto, o, to))

    # per-row scalars (module docstring): D, c, D̂ — all from forward
    # residuals; padded q rows carry zero cotangents so they contribute 0.
    d_row = jnp.sum(do * o, axis=-1)
    c_row = jnp.sum(dto * o, axis=-1)
    dhat_row = d_row + jnp.sum(dto * to, axis=-1) - c_row * mu
    block = q_block_size(batch, head, k.shape[2], q_tokens)
    blocks = [split_q_blocks(x, block) for x in
              (q, tq, do, dto, lse.astype(f32), mu.astype(f32), c_row, dhat_row)]

    def step(acc, args):
        i, q_b, tq_b, do_b, dto_b, lse_b, mu_b, c_b, dhat_b = args
        p = block_probs(q_b, k, lse_b, i * block, qk_scale, causal, exact)
        ts = (einsum("bhqd,bhkd->bhqk", tq_b, k, exact)
              + einsum("bhqd,bhkd->bhqk", q_b, tk, exact)) * sm_scale
        tsmu = ts - mu_b[..., None]
        tpb = einsum("bhqd,bhkd->bhqk", dto_b, v, exact)          # tP̄ = tŌ Vᵀ
        pbar = (einsum("bhqd,bhkd->bhqk", do_b, v, exact)         # Ō Vᵀ
                + einsum("bhqd,bhkd->bhqk", dto_b, tv, exact)     # tŌ tVᵀ
                + tpb * tsmu - c_b[..., None] * ts)
        ds = p * (pbar - dhat_b[..., None])
        tsb = p * (tpb - c_b[..., None])
        tp = p * tsmu
        dk, dv, dtk, dtv = acc
        dv = dv + einsum("bhqk,bhqd->bhkd", p, do_b, exact) + einsum("bhqk,bhqd->bhkd", tp, dto_b, exact)
        dtv = dtv + einsum("bhqk,bhqd->bhkd", p, dto_b, exact)
        dk = dk + (einsum("bhqk,bhqd->bhkd", ds, q_b, exact)
                   + einsum("bhqk,bhqd->bhkd", tsb, tq_b, exact)) * sm_scale
        dtk = dtk + einsum("bhqk,bhqd->bhkd", tsb, q_b, exact) * sm_scale
        dq = (einsum("bhqk,bhkd->bhqd", ds, k, exact)
              + einsum("bhqk,bhkd->bhqd", tsb, tk, exact)) * sm_scale
        dtq = einsum("bhqk,bhkd->bhqd", tsb, k, exact) * sm_scale
        return (dk, dv, dtk, dtv), (dq, dtq)

    zeros = jnp.zeros_like(k)
    n_blocks = blocks[0].shape[0]
    (dk, dv, dtk, dtv), (dq, dtq) = jax.lax.scan(
        step, (zeros, zeros, zeros, zeros), (jnp.arange(n_blocks), *blocks)
    )
    return (merge_q_blocks(dq, q_tokens), dk, dv, merge_q_blocks(dtq, q_tokens), dtk, dtv)
