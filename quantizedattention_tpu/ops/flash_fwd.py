"""Corrected-bf16 flash-attention forward (Pallas, Triton route).

The reference's Helion kernel `helion_atten_bf16_fwd_training`
(attention_bf16.py:107-296) as a Triton-route Pallas kernel: one program per
(b·h_kv, q tile), the kv loop inside the program (`lax.fori_loop`), online
softmax in registers, and the P tile rounded to bf16 so the P@V product runs
on the tensor cores, with the arXiv:2510.04212 tied-max rule (BETA) or the
zero-cost ulp bias (EPS) preventing the exp2(S-m)~1 bf16 rounding failure.

Divergences from the reference (SURVEY.md §2.3 / §7):
  * Softmax statistics (m, l, accumulator) are f32; the reference holds m
    in bf16 (attention_bf16.py:197). The capability that matters — bf16 P
    on the matrix unit with corrected numerics — is kept.
  * Q/K/V arrive in bf16 rather than fp16.
  * GQA-native: the q heads of one kv head are folded into the rows of the
    q tile (ops/common.fold_group), so each K/V tile is read once per kv
    head and one dot serves the whole group.
  * Causal kv tiles wholly above the diagonal are never visited; tiles
    wholly below it skip the mask.

precision="fp32" (the oracle-grade primal of the JVP family) runs plain
JAX with IEEE f32 dots (ops/plain.attention_fwd): on the card the Triton
route's f32 dots run on the CUDA cores and lost to XLA at HIGHEST by 1.9x
at (4,16,4096,64) and 2.6x at (2,8,4096,128) (PERF.md).

Returns (O f32 [b,h,q,d], lse f32 [b,h,q]) with lse = m + log2(l) in the exp2
domain, the residual contract the backward consumes
(attention_bf16.py:288-296).
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
    fold_group,
    pad_tokens,
    qk_scales,
    tile_mask,
    triton_call,
    unfold_group,
)
from quantizedattention_tpu.quantize.bf16_correction import (
    APPROX_MAX_TOL,
    BETA,
    EPS_BIAS,
)
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config
from quantizedattention_tpu.utils.runtime import use_interpret_mode


def _fwd_kernel(
    off_ref, q_ref, k_ref, v_ref, o_ref, lse_ref,
    *, causal, kv_len, num_kv_blocks, block_q, block_kv, correction, beta, tol,
):
    qi = pl.program_id(1)
    rows, head_dim = q_ref.shape
    q = q_ref[...]  # pre-scaled by qk_scale, bf16
    q_start = off_ref[0] + qi * block_q
    k_offset = off_ref[1]
    row_pos = q_start + jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(j, carry, masked):
        acc, m_prev, l_prev = carry
        k = k_ref[pl.ds(j * block_kv, block_kv), :]
        v = v_ref[pl.ds(j * block_kv, block_kv), :]
        s = dot(q, k, trans_b=True)  # [rows, block_kv] f32
        if masked:
            col_local = j * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
            mask = tile_mask(row_pos, col_local + k_offset, kv_len, causal, col_local)
            s = jnp.where(mask, s, MASK_VALUE)
        m_cur = jnp.max(s, axis=1)
        if correction == "eps":
            # zero-cost rule: bias the row max by one bf16 ulp so every P
            # entry lands strictly below 1.0 (any per-row max bias cancels
            # in the normalization)
            m_cur = m_cur + EPS_BIAS
        m_next = jnp.maximum(m_prev, m_cur)
        if correction == "beta":
            # reference-parity rule (arXiv:2510.04212,
            # attention_bf16.py:241-264): amplify tied maxima
            ties = jnp.sum((s >= (m_next - tol)[:, None]).astype(jnp.int32), axis=1)
            amplified = jnp.where(m_next > 0, beta * m_next, 0.0)
            m_next = jnp.where(ties > 1, amplified, m_next)
        p = jnp.exp2(s - m_next[:, None]).astype(jnp.bfloat16)
        alpha = jnp.exp2(m_prev - m_next)
        # l sums the *rounded* P that enters the PV product, so the epilogue
        # normalization matches the accumulated mass (attention_bf16.py:274)
        l_next = l_prev * alpha + jnp.sum(p.astype(jnp.float32), axis=1)
        acc = acc * alpha[:, None] + dot(p, v)
        return acc, m_next, l_next

    carry = (
        jnp.zeros((rows, head_dim), jnp.float32),
        jnp.full((rows,), -jnp.inf, jnp.float32),
        jnp.zeros((rows,), jnp.float32),
    )
    n_clean, n_live = causal_kv_bounds(q_start, k_offset, block_q, block_kv,
                                       kv_len, num_kv_blocks, causal)
    carry = jax.lax.fori_loop(0, n_clean, functools.partial(body, masked=False), carry)
    carry = jax.lax.fori_loop(n_clean, n_live, functools.partial(body, masked=True), carry)
    acc, m, l = carry
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o_ref[...] = acc / l_safe[:, None]
    lse_ref[...] = m + jnp.log2(l_safe)


@functools.partial(
    jax.jit,
    static_argnames=(
        "causal", "sm_scale", "config", "precision", "correction", "beta", "tol",
        "interpret",
    ),
)
def flash_attention_fwd(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    precision: str = "bf16",
    correction: str = "eps",
    beta: float = BETA,
    tol: float = APPROX_MAX_TOL,
    interpret: bool | None = None,
    q_offset: jnp.ndarray | int = 0,
    k_offset: jnp.ndarray | int = 0,
):
    """Flash-attention forward. q: [batch, head, tokens, head_dim];
    k/v: [batch, kv_head, kv_tokens, head_dim] with kv_head dividing head
    (GQA-native: K/V stream once per kv head and serve the whole q group).

    precision: "bf16" rounds P to bf16 for the tensor cores (the
    reference's training path, the Triton kernel); "fp32" keeps everything
    f32 with IEEE dots (oracle-grade, used by the JVP family; plain JAX).
    correction: "eps" (zero-cost ulp bias, default), "beta" (the reference's
    tied-max amplification rule), or "none".
    q_offset/k_offset: global token positions of the local q / kv shards
    (causal masking under sequence parallelism).
    Returns (O f32, lse f32 [b, h, q_tokens]).
    """
    if interpret is None:
        interpret = use_interpret_mode()
    batch, head, q_tokens, head_dim = q.shape
    kv_head, kv_len = k.shape[1], k.shape[2]
    if head % kv_head != 0:
        raise ValueError(f"q heads ({head}) must be a multiple of kv heads ({kv_head})")
    if precision == "fp32":
        return plain.attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset, k_offset=k_offset)
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    if config is None:
        config = default_block_config("bf16", q_tokens, kv_len, head_dim)
    config = config.for_group(head // kv_head)
    block_q, block_kv = config.block_q, config.block_kv
    _, qk_scale = qk_scales(head_dim, sm_scale)

    # pre-scale Q in f32 so the kernel's logits arrive in the exp2 domain
    bh_kv = batch * kv_head
    bf16 = jnp.bfloat16
    qf = fold_group((q.astype(jnp.float32) * qk_scale).astype(bf16), kv_head, block_q)
    k3 = pad_tokens(k.astype(bf16).reshape(bh_kv, kv_len, head_dim), block_kv, 1)
    v3 = pad_tokens(v.astype(bf16).reshape(bh_kv, kv_len, head_dim), block_kv, 1)
    _, nq, rows, _ = qf.shape
    padded_kv = k3.shape[1]
    offsets = jnp.stack([jnp.asarray(q_offset, jnp.int32), jnp.asarray(k_offset, jnp.int32)])

    kernel = functools.partial(
        _fwd_kernel, causal=causal, kv_len=kv_len,
        num_kv_blocks=padded_kv // block_kv, block_q=block_q, block_kv=block_kv,
        correction=correction, beta=beta, tol=tol,
    )
    o, lse = triton_call(
        kernel,
        grid=(bh_kv, nq),
        in_specs=[
            pl.BlockSpec((2,), lambda b, i: (0,)),
            pl.BlockSpec((None, None, rows, head_dim), lambda b, i: (b, i, 0, 0)),
            pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, None, rows, head_dim), lambda b, i: (b, i, 0, 0)),
            pl.BlockSpec((None, None, rows), lambda b, i: (b, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bh_kv, nq, rows, head_dim), jnp.float32),
            jax.ShapeDtypeStruct((bh_kv, nq, rows), jnp.float32),
        ],
        config=config,
        interpret=interpret,
        name="flash_fwd",
    )(offsets, qf, k3, v3)
    return unfold_group(o, batch, head, q_tokens), unfold_group(lse, batch, head, q_tokens)
