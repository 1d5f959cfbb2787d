"""Forward-mode (JVP) flash attention (Pallas, Triton route).

The reference's `helion_attention_jvp_forward_fp32` (attention_jvp.py:24-195),
used for flow-matching diffusion distillation (NVIDIA rCM,
attention_jvp.py:1-11). Computes both the primal output O and the tangent
output tO in a single streaming pass: one program per (b·h, q tile), the kv
loop inside the program.

Math (attention_jvp.py:43-56):
    tS = (tQ Kᵀ + Q tKᵀ) · sm_scale        (natural-log domain)
    H  = P ∘ tS                            (P un-normalized, exp2 domain)
    tO = (A + B − r ∘ O) / l   where  A = P tV,  B = H V,  r = rowsum(H)

Six online accumulators (m, l, O, r, A, B) live in registers across kv
tiles, each rescaled by exp2(m − m') per tile — the identity the reference
applies at attention_jvp.py:155-181.

Precision: fast=True (the rCM training step's choice) is this kernel: dot
operands rounded to bf16, f32 accumulation on the tensor cores. The default
— IEEE f32 like the reference kernel — runs plain JAX
(ops/plain.attention_jvp_fwd): on the card the Triton route's f32 dots lost
to XLA at HIGHEST by 1.8x at d=64 and 59x at d=128 (PERF.md).

Superset capability: the reference kernel is non-causal only; this one takes
`causal`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from quantizedattention_tpu.ops import plain
from quantizedattention_tpu.ops.common import (
    MASK_VALUE,
    causal_kv_bounds,
    dot,
    pad_tokens,
    qk_scales,
    tile_mask,
    triton_call,
)
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config
from quantizedattention_tpu.utils.runtime import use_interpret_mode


def _jvp_kernel(
    q_ref, k_ref, v_ref, tq_ref, tk_ref, tv_ref,
    o_ref, to_ref, lse_ref, mu_ref,
    *, sm_scale, qk_scale, causal, kv_len, num_kv_blocks, block_q, block_kv,
):
    qi = pl.program_id(1)
    head_dim = q_ref.shape[1]
    q, tq = q_ref[...], tq_ref[...]
    q_start = qi * block_q
    row_pos = q_start + jax.lax.broadcasted_iota(jnp.int32, (block_q,), 0)

    def body(j, carry, masked):
        m_prev, l, r, o, a, b = carry
        kv_slice = pl.ds(j * block_kv, block_kv)
        k, v = k_ref[kv_slice, :], v_ref[kv_slice, :]
        tk, tv = tk_ref[kv_slice, :], tv_ref[kv_slice, :]
        s = dot(q, k, trans_b=True) * qk_scale
        # tangent logits in the natural-log domain (attention_jvp.py:148-153)
        ts = (dot(tq, k, trans_b=True) + dot(q, tk, trans_b=True)) * sm_scale
        if masked:
            col = j * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
            mask = tile_mask(row_pos, col, kv_len, causal)
            s = jnp.where(mask, s, MASK_VALUE)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=1))
        p = jnp.exp2(s - m_next[:, None])
        if masked:
            p = jnp.where(mask, p, 0.0)
        alpha = jnp.exp2(m_prev - m_next)
        h = p * ts
        l = l * alpha + jnp.sum(p, axis=1)
        r = r * alpha + jnp.sum(h, axis=1)
        o = o * alpha[:, None] + dot(p, v)
        a = a * alpha[:, None] + dot(p, tv)
        b = b * alpha[:, None] + dot(h, v)
        return m_next, l, r, o, a, b

    rows = jnp.zeros((block_q,), jnp.float32)
    tile = jnp.zeros((block_q, head_dim), jnp.float32)
    carry = (jnp.full((block_q,), -jnp.inf, jnp.float32), rows, rows, tile, tile, tile)
    n_clean, n_live = causal_kv_bounds(q_start, 0, block_q, block_kv, kv_len,
                                       num_kv_blocks, causal)
    carry = jax.lax.fori_loop(0, n_clean, functools.partial(body, masked=False), carry)
    carry = jax.lax.fori_loop(n_clean, n_live, functools.partial(body, masked=True), carry)
    m, l, r, o, a, b = carry
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = o / l_safe[:, None]
    o_ref[...] = o
    # tO = (A + B − r·O) / l   (attention_jvp.py:190)
    to_ref[...] = (a + b - r[:, None] * o) / l_safe[:, None]
    lse_ref[...] = m + jnp.log2(l_safe)
    # mu = rowsum(P_norm ∘ tS) = r / l — the tangent-softmax row term the
    # second-order backward (jvp_bwd) needs as a residual
    mu_ref[...] = r / l_safe


@functools.partial(
    jax.jit, static_argnames=("causal", "sm_scale", "config", "fast", "interpret")
)
def attention_jvp_fwd(
    q, k, v, tq, tk, tv,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
    interpret: bool | None = None,
):
    """JVP attention. Returns (O, tO, lse, mu), all f32; inputs [b, h, t, d].

    mu = rowsum(P ∘ tS) (P normalized, tS natural-log domain) — the tangent
    row term; together with lse it is the residual set the second-order
    backward (ops/jvp_bwd) reuses without recomputing the streaming pass.
    fast=True runs the Triton kernel (bf16 dot operands, f32 accumulation);
    the default runs IEEE f32 dots in plain JAX.
    """
    if interpret is None:
        interpret = use_interpret_mode()
    batch, head, q_tokens, head_dim = q.shape
    kv_len = k.shape[2]
    if k.shape[1] != head:
        raise ValueError(
            f"the JVP family is single-head-count only: q has {head} heads but "
            f"k/v have {k.shape[1]} — GQA is unsupported here (unlike "
            "flash/int8 attention); jnp.repeat k/v to the q head count first"
        )
    if not fast:
        return plain.attention_jvp_fwd(q, k, v, tq, tk, tv, causal=causal, sm_scale=sm_scale)
    if config is None:
        config = default_block_config("jvp", q_tokens, kv_len, head_dim)
    block_q, block_kv = config.block_q, config.block_kv
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    bh = batch * head
    dt = jnp.bfloat16

    def prep(x, block):
        return pad_tokens(x.astype(dt).reshape(bh, x.shape[2], head_dim), block, 1)

    q3, tq3 = prep(q, block_q), prep(tq, block_q)
    k3, tk3 = prep(k, block_kv), prep(tk, block_kv)
    v3, tv3 = prep(v, block_kv), prep(tv, block_kv)
    padded_q, padded_kv = q3.shape[1], k3.shape[1]

    kernel = functools.partial(
        _jvp_kernel, sm_scale=sm_scale, qk_scale=qk_scale, causal=causal,
        kv_len=kv_len, num_kv_blocks=padded_kv // block_kv, block_q=block_q,
        block_kv=block_kv,
    )
    q_tile = pl.BlockSpec((None, block_q, head_dim), lambda b, i: (b, i, 0))
    kv_all = pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0))
    row_tile = pl.BlockSpec((None, block_q), lambda b, i: (b, i))
    f32 = jnp.float32
    o, to, lse, mu = triton_call(
        kernel,
        grid=(bh, padded_q // block_q),
        in_specs=[q_tile, kv_all, kv_all, q_tile, kv_all, kv_all],
        out_specs=[q_tile, q_tile, row_tile, row_tile],
        out_shape=[
            jax.ShapeDtypeStruct((bh, padded_q, head_dim), f32),
            jax.ShapeDtypeStruct((bh, padded_q, head_dim), f32),
            jax.ShapeDtypeStruct((bh, padded_q), f32),
            jax.ShapeDtypeStruct((bh, padded_q), f32),
        ],
        config=config,
        interpret=interpret,
        name="jvp_fwd",
    )(q3, k3, v3, tq3, tk3, tv3)

    def cut(x):
        return x[:, :q_tokens].reshape(batch, head, q_tokens, *x.shape[2:])

    return cut(o), cut(to), cut(lse), cut(mu)
