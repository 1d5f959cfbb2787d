"""SageAttention3-style INT8 backward (Pallas, Triton route) for int8
fine-tuning.

The reference's `helion_atten_int8_hl_dot_bwd` (attention_int8.py:264-432):
recomputes S from the *forward's* quantized Q/K blocks and scales (no
re-quantization of Q/K — the residual contract of attention_int8.py:58-65).
Three of the five products run int8 x int8 -> int32 on the tensor cores,
where the reference has int8 dots:

  * S  = Q Kᵀ on the forward's payloads (bit-equal recompute);
  * dP = dO Vᵀ with dO quantized per row (the reference quantizes dO per
    tile, attention_int8.py:363-374);
  * dQ = dS K with dS quantized per row inside the dQ kernel
    (attention_int8.py:403-405).

dV = Pᵀ dO stays bf16, as in SageAttention3 (P is near-uniform, so the
contraction averages dO toward zero and int8 noise would swamp it), and so
does dK = dSᵀ Q: its contraction runs over q rows, whose per-row scales do
not factor out of the sum.

Structure: two race-free kernels like the bf16 backward —
  * dKV: one program per (b·h_kv, kv tile), looping over q tiles;
  * dQ : one program per (b·h_kv, q tile), looping over kv tiles, adding
    the K-smoothing compensation rowsum(dS)·k_mean per q row
    (SageAttention3; the reference's version indexes k_mean by the wrong
    axis, attention_int8.py:408-410 — SURVEY.md §2.3 Q3).

Math fixes vs the reference (SURVEY.md §2.3): dS = P ∘ (dP − D) (not S ∘ ·,
Q1); gradients scaled by sm_scale, not the exp2-domain qk_scale; distinct
q/kv token counts are handled (the reference's dk/dv indexing only works
when they coincide, Q5). Validated against jax.grad of the fp32 oracle.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from quantizedattention_tpu.ops.common import (
    MASK_VALUE,
    causal_kv_bounds,
    dot,
    fold_group,
    qk_scales,
    tile_mask,
    triton_call,
    unfold_group,
)
from quantizedattention_tpu.ops.int8_fwd import residual_tiles
from quantizedattention_tpu.quantize.int8 import _EPS, INT8_MAX
from quantizedattention_tpu.tune.config import (
    BWD_STAGES,
    INT8_BWD_WARPS,
    BlockConfig,
    default_block_config,
)
from quantizedattention_tpu.utils.runtime import use_interpret_mode


def _recompute_p(q_i8, row_scale, k_i8, k_scale, lse, row_pos, col_local,
                 k_offset, kv_len, causal):
    """P = exp2(S − lse) from the forward's int8 payloads (int32 dot)."""
    qk = dot(q_i8, k_i8, trans_b=True, out=jnp.int32).astype(jnp.float32)
    s = qk * (row_scale * k_scale)[:, None]
    mask = tile_mask(row_pos, col_local + k_offset, kv_len, causal, col_local)
    s = jnp.where(mask, s, MASK_VALUE)
    return jnp.exp2(s - lse[:, None])


def _round_i8(x):
    """Round-half-away-from-zero to int8 (|x| <= 127 by construction)."""
    return jnp.where(x >= 0, x + 0.5, x - 0.5).astype(jnp.int32).astype(jnp.int8)


def _int8_dkv_kernel(
    off_ref, q_ref, sq_ref, k_ref, sk_ref, v_ref, sv_ref, do_ref, do8_ref,
    sdo_ref, lse_ref, di_ref, dk_ref, dv_ref,
    *, sm_scale, qk_scale, causal, kv_len, num_q_blocks, block_q, block_kv,
):
    kj = pl.program_id(1)
    rows = q_ref.shape[1]
    head_dim = k_ref.shape[1]
    k = k_ref[...]
    v = v_ref[...]
    k_scale = sk_ref[kj]
    v_scale = sv_ref[kj]
    col_local = kj * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
    q_offset, k_offset = off_ref[0], off_ref[1]
    row_in_tile = jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(i, carry):
        dk, dv = carry
        sq = sq_ref[i]
        row_pos = q_offset + i * block_q + row_in_tile
        p = _recompute_p(q_ref[i], sq * qk_scale, k, k_scale, lse_ref[i], row_pos,
                         col_local, k_offset, kv_len, causal)
        # dV += Pᵀ dO in bf16 (SageAttention3)
        dv = dv + dot(p, do_ref[i], trans_a=True)
        # dP = dO Vᵀ, int8 x int8 -> int32, per-row dO scale x tile V scale
        dp = dot(do8_ref[i], v, trans_b=True, out=jnp.int32).astype(jnp.float32)
        dp = dp * (sdo_ref[i] * v_scale)[:, None]
        ds = p * (dp - di_ref[i][:, None]) * sm_scale
        # dK += (dS · sq)ᵀ Q_i8 in bf16 (the int8 payload is exact in bf16)
        dk = dk + dot(ds * sq[:, None], q_ref[i].astype(jnp.bfloat16), trans_a=True)
        return dk, dv

    lo = 0
    if causal:
        first_key = k_offset + kj * block_kv - q_offset
        lo = jnp.minimum(jnp.maximum(first_key, 0) // block_q, num_q_blocks)
    zeros = jnp.zeros((block_kv, head_dim), jnp.float32)
    dk, dv = jax.lax.fori_loop(lo, num_q_blocks, body, (zeros, zeros))
    dk_ref[...] = dk
    dv_ref[...] = dv


def _int8_dq_kernel(
    off_ref, q_ref, sq_ref, k_ref, sk_ref, v_ref, sv_ref, do8_ref, sdo_ref,
    lse_ref, di_ref, kmean_ref, dq_ref,
    *, sm_scale, qk_scale, causal, kv_len, num_kv_blocks, block_q, block_kv,
):
    qi = pl.program_id(1)
    rows, head_dim = q_ref.shape
    q = q_ref[...]
    row_scale = sq_ref[...] * qk_scale
    do8 = do8_ref[...]
    sdo = sdo_ref[...]
    lse = lse_ref[...]
    di = di_ref[...]
    q_start = off_ref[0] + qi * block_q
    k_offset = off_ref[1]
    row_pos = q_start + jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(j, carry):
        dq, ds_sum = carry
        k = k_ref[pl.ds(j * block_kv, block_kv), :]
        v = v_ref[pl.ds(j * block_kv, block_kv), :]
        col_local = j * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
        p = _recompute_p(q, row_scale, k, sk_ref[j], lse, row_pos, col_local,
                         k_offset, kv_len, causal)
        dp = dot(do8, v, trans_b=True, out=jnp.int32).astype(jnp.float32)
        dp = dp * (sdo * sv_ref[j])[:, None]
        ds = p * (dp - di[:, None]) * sm_scale
        # dQ += dS K_smoothed: dS quantized per row, int8 x int8 -> int32
        s_ds = jnp.maximum(jnp.max(jnp.abs(ds), axis=1), _EPS) / INT8_MAX
        ds8 = _round_i8(ds / s_ds[:, None])
        dq_t = dot(ds8, k, out=jnp.int32).astype(jnp.float32)
        dq = dq + dq_t * (s_ds * sk_ref[j])[:, None]
        return dq, ds_sum + jnp.sum(ds, axis=1)

    _, hi = causal_kv_bounds(q_start, k_offset, block_q, block_kv, kv_len,
                             num_kv_blocks, causal)
    dq, ds_sum = jax.lax.fori_loop(
        0, hi, body,
        (jnp.zeros((rows, head_dim), jnp.float32), jnp.zeros((rows,), jnp.float32)),
    )
    # + rowsum(dS)·k_mean undoes K-smoothing in the gradient (dS rows sum
    # to ~0, so this is a small correction; SageAttention3)
    dq_ref[...] = dq + ds_sum[:, None] * kmean_ref[...][None, :]


@functools.partial(
    jax.jit, static_argnames=("dims", "causal", "sm_scale", "config", "interpret")
)
def int8_attention_bwd(
    residuals,
    k_mean: jnp.ndarray,
    o: jnp.ndarray,
    lse: jnp.ndarray,
    do: jnp.ndarray,
    dims,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    interpret: bool | None = None,
    q_offset: jnp.ndarray | int = 0,
    k_offset: jnp.ndarray | int = 0,
):
    """INT8 backward from the forward's quantized residuals (quantize_qkv's
    layout; K smoothed). GQA (h_kv < h): dk/dv come back on the kv-head
    count, the group sum taken inside the dKV kernel.

    k_mean: [b, h_kv, 1, d] token-mean of the *original* K.
    dims: (batch, head, q_tokens, kv_len, head_dim).
    Returns (dq, dk, dv) in f32 on [b, h(, h_kv), t, d].
    """
    if interpret is None:
        interpret = use_interpret_mode()
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    batch, head, q_tokens, kv_len, head_dim = dims
    if config is None:
        config = default_block_config("int8", q_tokens, kv_len, head_dim)
    config = dataclasses.replace(config, num_stages=BWD_STAGES, num_warps=INT8_BWD_WARPS)
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    bh_kv, nq, rows, _ = q_i8.shape
    kv_head = bh_kv // batch
    # the backward reuses the forward's quantization, so its tiling is the
    # quantization grain (the reference threads (Bq, Bkv) through ctx.args
    # for the same reason, attention_int8.py:65,81)
    block_q, block_kv = residual_tiles(residuals, batch, head)
    padded_kv, nkv = k_i8.shape[1], sk.shape[1]
    f32 = jnp.float32

    dof = fold_group(do.astype(f32), kv_head, block_q)
    of = fold_group(o.astype(f32), kv_head, block_q)
    di = jnp.sum(dof * of, axis=-1)
    sdo = jnp.maximum(jnp.max(jnp.abs(dof), axis=-1), 1e-12) / INT8_MAX
    do8 = jnp.clip(jnp.round(dof / sdo[..., None]), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    do_bf = dof.astype(jnp.bfloat16)
    lsef = fold_group(lse.astype(f32), kv_head, block_q)
    kmean = k_mean.astype(f32).reshape(bh_kv, head_dim)
    sq, sk, sv = sq.astype(f32), sk.astype(f32), sv.astype(f32)
    offsets = jnp.stack([jnp.asarray(q_offset, jnp.int32), jnp.asarray(k_offset, jnp.int32)])
    common = dict(sm_scale=sm_scale, qk_scale=qk_scale, causal=causal,
                  kv_len=kv_len, block_q=block_q, block_kv=block_kv)
    off_spec = pl.BlockSpec((2,), lambda b, j: (0,))
    scale_all = pl.BlockSpec((None, nkv), lambda b, j: (b, 0))

    # --- dKV pass: one program per (b·h_kv, kv tile) ---
    q_all = pl.BlockSpec((None, nq, rows, head_dim), lambda b, j: (b, 0, 0, 0))
    row_all = pl.BlockSpec((None, nq, rows), lambda b, j: (b, 0, 0))
    kv_tile = pl.BlockSpec((None, block_kv, head_dim), lambda b, j: (b, j, 0))
    dk, dv = triton_call(
        functools.partial(_int8_dkv_kernel, num_q_blocks=nq, **common),
        grid=(bh_kv, nkv),
        in_specs=[off_spec, q_all, row_all, kv_tile, scale_all, kv_tile, scale_all,
                  q_all, q_all, row_all, row_all, row_all],
        out_specs=[kv_tile, kv_tile],
        out_shape=[jax.ShapeDtypeStruct((bh_kv, padded_kv, head_dim), f32)] * 2,
        config=config, interpret=interpret, name="int8_bwd_dkv",
    )(offsets, q_i8, sq, k_i8, sk, v_i8, sv, do_bf, do8, sdo, lsef, di)

    # --- dQ pass: one program per (b·h_kv, q tile) ---
    q_tile = pl.BlockSpec((None, None, rows, head_dim), lambda b, i: (b, i, 0, 0))
    row_tile = pl.BlockSpec((None, None, rows), lambda b, i: (b, i, 0))
    kv_all = pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0))
    (dq,) = triton_call(
        functools.partial(_int8_dq_kernel, num_kv_blocks=nkv, **common),
        grid=(bh_kv, nq),
        in_specs=[off_spec, q_tile, row_tile, kv_all, scale_all, kv_all, scale_all,
                  q_tile, row_tile, row_tile, row_tile,
                  pl.BlockSpec((None, head_dim), lambda b, i: (b, 0))],
        out_specs=[q_tile],
        out_shape=[jax.ShapeDtypeStruct((bh_kv, nq, rows, head_dim), f32)],
        config=config, interpret=interpret, name="int8_bwd_dq",
    )(offsets, q_i8, sq, k_i8, sk, v_i8, sv, do8, sdo, lsef, di, kmean)

    dq = unfold_group(dq, batch, head, q_tokens)
    dk = dk[:, :kv_len].reshape(batch, kv_head, kv_len, head_dim)
    dv = dv[:, :kv_len].reshape(batch, kv_head, kv_len, head_dim)
    return dq, dk, dv
