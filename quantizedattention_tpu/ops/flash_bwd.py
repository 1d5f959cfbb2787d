"""FlashAttention-2 Algorithm-4 backward (Pallas, Triton route).

The reference's `helion_flash_atten_2_algo_4_bwd` (attention_bf16.py:299-448)
split into two race-free kernels:

  * dKV kernel — one program per (b·h_kv, kv tile), looping over q tiles;
    accumulates dK and dV for its kv tile in registers.
  * dQ kernel — one program per (b·h_kv, q tile), looping over kv tiles;
    accumulates dQ for its q tile in registers.

This removes the reference's dq read-modify-write race (different k-tile
programs read+write the same dq rows through global memory,
attention_bf16.py:427-432 — SURVEY.md §2.3 Q2): each output element is
owned by exactly one program, so no atomics are needed.

Math fixes vs the reference (SURVEY.md §2.3 Q1): FA2 Algorithm 4 derives
dS = P ∘ (dP − D); the reference multiplies by the *logits* S instead
(attention_bf16.py:421). We implement the correct formula and validate
against jax.grad of the fp32 oracle. D = rowsum(dO ∘ O) is precomputed once
outside the kernels and shared by both passes.

GQA: the q group of a kv head is folded into the rows of each q tile
(ops/common.fold_group), so the dKV pass sums the group's contributions in
the same dot. The kernels round dot operands to bf16 with f32 accumulation
on the tensor cores; the exact mode (IEEE f32, the reference's fp32
backward, attention_bf16.py:342-344) runs plain JAX (ops/plain.py): the
Triton route's f32 dots lost to XLA at HIGHEST by 3.5x and 6.4x on the card
(PERF.md).
"""

from __future__ import annotations

import dataclasses
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
from quantizedattention_tpu.tune.config import (
    BWD_STAGES,
    BlockConfig,
    default_block_config,
    max_rows,
)
from quantizedattention_tpu.utils.runtime import use_interpret_mode


def _recompute_p(q, k, lse, row_pos, col_local, k_offset, kv_len, causal):
    """P = exp2(S_scaled − lse); q arrives pre-scaled by qk_scale, masked
    logits underflow to exactly 0 since lse is finite."""
    s = dot(q, k, trans_b=True)
    mask = tile_mask(row_pos, col_local + k_offset, kv_len, causal, col_local)
    s = jnp.where(mask, s, MASK_VALUE)
    return jnp.exp2(s - lse[:, None])


def _dkv_kernel(
    off_ref, q_ref, k_ref, v_ref, do_ref, lse_ref, di_ref, dk_ref, dv_ref,
    *, qk_scale, sm_scale, causal, kv_len, num_q_blocks, block_q, block_kv,
):
    kj = pl.program_id(1)
    rows = q_ref.shape[1]
    head_dim = k_ref.shape[1]
    k = k_ref[...]
    v = v_ref[...]
    col_local = kj * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
    q_offset, k_offset = off_ref[0], off_ref[1]
    row_in_tile = jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(i, carry):
        dk, dv = carry
        q = q_ref[i]      # [rows, d], pre-scaled by qk_scale
        do = do_ref[i]    # pre-scaled by sm_scale
        row_pos = q_offset + i * block_q + row_in_tile
        p = _recompute_p(q, k, lse_ref[i], row_pos, col_local, k_offset, kv_len,
                         causal)
        # dV += Pᵀ dO_scaled (/sm_scale at the end)
        dv = dv + dot(p, do, trans_a=True)
        # dP_scaled = dO_scaled Vᵀ; sm_scale is folded into dp and di
        dp = dot(do, v, trans_b=True)
        ds = p * (dp - di_ref[i][:, None])
        # dK += dSᵀ Q_scaled (/qk_scale at the end)
        dk = dk + dot(ds, q, trans_a=True)
        return dk, dv

    lo = 0
    if causal:
        # the first q tile whose last row reaches this kv tile's first key
        first_key = k_offset + kj * block_kv - q_offset
        lo = jnp.minimum(jnp.maximum(first_key, 0) // block_q, num_q_blocks)
    zeros = jnp.zeros((block_kv, head_dim), jnp.float32)
    dk, dv = jax.lax.fori_loop(lo, num_q_blocks, body, (zeros, zeros))
    dk_ref[...] = dk * (1.0 / qk_scale)
    dv_ref[...] = dv * (1.0 / sm_scale)


def _dq_kernel(
    off_ref, q_ref, k_ref, v_ref, do_ref, lse_ref, di_ref, dq_ref,
    *, causal, kv_len, num_kv_blocks, block_q, block_kv,
):
    qi = pl.program_id(1)
    rows, head_dim = q_ref.shape
    q = q_ref[...]
    do = do_ref[...]
    lse = lse_ref[...]
    di = di_ref[...]
    q_start = off_ref[0] + qi * block_q
    k_offset = off_ref[1]
    row_pos = q_start + jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(j, dq):
        k = k_ref[pl.ds(j * block_kv, block_kv), :]
        v = v_ref[pl.ds(j * block_kv, block_kv), :]
        col_local = j * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
        p = _recompute_p(q, k, lse, row_pos, col_local, k_offset, kv_len, causal)
        dp = dot(do, v, trans_b=True)
        ds = p * (dp - di[:, None])
        # dQ += dS K (K unscaled, so dq needs no fixup)
        return dq + dot(ds, k)

    _, hi = causal_kv_bounds(q_start, k_offset, block_q, block_kv, kv_len,
                             num_kv_blocks, causal)
    dq = jax.lax.fori_loop(0, hi, body, jnp.zeros((rows, head_dim), jnp.float32))
    dq_ref[...] = dq


@functools.partial(
    jax.jit,
    static_argnames=("causal", "sm_scale", "config", "fast", "interpret"),
)
def flash_attention_bwd(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    o: jnp.ndarray,
    lse: jnp.ndarray,
    do: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
    interpret: bool | None = None,
    q_offset: jnp.ndarray | int = 0,
    k_offset: jnp.ndarray | int = 0,
):
    """FA2 backward. Residuals (q, k, v, O, lse) match the forward's outputs.

    k/v may carry fewer heads than q (GQA): dk/dv come back on the kv-head
    count, the group sum taken inside the dKV kernel.

    lse: [b, h, q_tokens] in the exp2 domain (m + log2 l). Returns
    (dq, dk, dv) in f32. `fast=True` runs the Triton kernels (bf16 dot
    operands, f32 accumulation, tensor cores); the default runs IEEE f32
    dots in plain JAX.
    """
    if interpret is None:
        interpret = use_interpret_mode()
    batch, head, q_tokens, head_dim = q.shape
    kv_head, kv_len = k.shape[1], k.shape[2]
    if head % kv_head != 0:
        raise ValueError(f"q heads ({head}) must be a multiple of kv heads ({kv_head})")
    if not fast:
        return plain.attention_bwd(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset, k_offset=k_offset)
    if config is None:
        config = default_block_config("bf16", q_tokens, kv_len, head_dim)
    config = dataclasses.replace(config.for_group(head // kv_head, max_rows(head_dim)),
                                 num_stages=BWD_STAGES)
    block_q, block_kv = config.block_q_bwd, config.block_kv_bwd
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    dt = jnp.bfloat16

    bh_kv = batch * kv_head
    f32 = jnp.float32
    # fold the logit scale into Q and the gradient scale into dO once here
    qf = fold_group((q.astype(f32) * qk_scale).astype(dt), kv_head, block_q)
    dof = fold_group((do.astype(f32) * sm_scale), kv_head, block_q)
    of = fold_group(o.astype(f32), kv_head, block_q)
    # D = rowsum(dO ∘ O), shared by both passes (the reference recomputes it
    # per tile, attention_bf16.py:416); padded rows carry dO = 0
    di = jnp.sum(dof * of, axis=-1)
    dof = dof.astype(dt)
    lsef = fold_group(lse.astype(f32), kv_head, block_q)
    k3 = pad_tokens(k.astype(dt).reshape(bh_kv, kv_len, head_dim), block_kv, 1)
    v3 = pad_tokens(v.astype(dt).reshape(bh_kv, kv_len, head_dim), block_kv, 1)
    _, nq, rows, _ = qf.shape
    padded_kv = k3.shape[1]
    nkv = padded_kv // block_kv
    offsets = jnp.stack([jnp.asarray(q_offset, jnp.int32), jnp.asarray(k_offset, jnp.int32)])
    off_spec = pl.BlockSpec((2,), lambda b, j: (0,))

    q_all = pl.BlockSpec((None, nq, rows, head_dim), lambda b, j: (b, 0, 0, 0))
    row_all = pl.BlockSpec((None, nq, rows), lambda b, j: (b, 0, 0))
    kv_tile = pl.BlockSpec((None, block_kv, head_dim), lambda b, j: (b, j, 0))
    dk, dv = triton_call(
        functools.partial(
            _dkv_kernel, qk_scale=qk_scale, sm_scale=sm_scale, causal=causal,
            kv_len=kv_len, num_q_blocks=nq, block_q=block_q, block_kv=block_kv,
        ),
        grid=(bh_kv, nkv),
        in_specs=[off_spec, q_all, kv_tile, kv_tile, q_all, row_all, row_all],
        out_specs=[kv_tile, kv_tile],
        out_shape=[jax.ShapeDtypeStruct((bh_kv, padded_kv, head_dim), f32)] * 2,
        config=config, interpret=interpret, name="flash_bwd_dkv",
    )(offsets, qf, k3, v3, dof, lsef, di)

    q_tile = pl.BlockSpec((None, None, rows, head_dim), lambda b, i: (b, i, 0, 0))
    row_tile = pl.BlockSpec((None, None, rows), lambda b, i: (b, i, 0))
    kv_all = pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0))
    (dq,) = triton_call(
        functools.partial(
            _dq_kernel, causal=causal, kv_len=kv_len, num_kv_blocks=nkv,
            block_q=block_q, block_kv=block_kv,
        ),
        grid=(bh_kv, nq),
        in_specs=[off_spec, q_tile, kv_all, kv_all, q_tile, row_tile, row_tile],
        out_specs=[q_tile],
        out_shape=[jax.ShapeDtypeStruct((bh_kv, nq, rows, head_dim), f32)],
        config=config, interpret=interpret, name="flash_bwd_dq",
    )(offsets, qf, k3, v3, dof, lsef, di)

    dq = unfold_group(dq, batch, head, q_tokens)
    dk = dk[:, :kv_len].reshape(batch, kv_head, kv_len, head_dim)
    dv = dv[:, :kv_len].reshape(batch, kv_head, kv_len, head_dim)
    return dq, dk, dv
