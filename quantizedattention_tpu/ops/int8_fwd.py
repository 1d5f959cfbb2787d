"""SageAttention3-style INT8 flash-attention forward (Pallas, Triton route).

The reference's `helion_atten_int8_hl_dot_fwd` (attention_int8.py:97-262) as
one Triton-route kernel with true int8 x int8 -> int32 tensor-core dots for
both products:

  * S = Q Kᵀ runs on the int8 payloads of per-tile symmetric absmax/127
    quantized Q and K; the per-tile scales are applied after the dot.
  * P is quantized per row of each kv tile (the tile's largest entry maps to
    127, as the reference's sp = exp2(rowmax − m)/127,
    attention_int8.py:227-237) and P V runs int8 x int8 -> int32 against the
    per-tile quantized V; the row and tile scales are applied after the dot.
  * Online softmax runs in f32; l sums the dequantized int8 P that enters
    the PV product, so the normalization matches the accumulated mass.

Quantization of Q/K/V is a plain jnp pass (quantize/int8.py) that XLA fuses
into one read and a quarter-width write; its blocks and scales are the
residuals the int8 backward reuses (attention_int8.py:58-65). Inference
(`sage_attention_int8_inference`) runs the same two steps without keeping
the residuals.

Structural fixes vs the reference (SURVEY.md §2.3):
  * Q4 — the reference flattens [b,h,t,d] to [b·h·t, d] and lets softmax mix
    keys across batches and heads (attention_int8.py:129-136); here
    attention is per (batch, head): grid (b·h_kv, q tiles), the GQA group
    folded into the rows of a q tile.
  * Q7 — the reference re-quantizes Q on every kv iteration
    (attention_int8.py:178-186); here Q is quantized once per tile.
  * Q3 — K-smoothing subtracts the token-axis K mean (api.py), the axis
    SageAttention uses.

Superset capability: `causal` masking (the reference int8 kernel has none).
Outputs are f32 (the reference emits fp16).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

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
from quantizedattention_tpu.quantize.int8 import _EPS, INT8_MAX
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config, max_rows
from quantizedattention_tpu.utils.runtime import next_pow2, use_interpret_mode

# floor for the per-row P scale: a tile whose every entry underflowed has
# p == 0 exactly, so any positive floor keeps 0 * (127 / floor) == 0
_P_FLOOR = 1e-30


def _int8_fwd_kernel(
    off_ref, q_ref, sq_ref, k_ref, sk_ref, v_ref, sv_ref, o_ref, lse_ref,
    *, qk_scale, causal, kv_len, num_kv_blocks, block_q, block_kv,
):
    qi = pl.program_id(1)
    rows, head_dim = q_ref.shape
    q = q_ref[...]                       # int8 payload [rows, d]
    row_scale = sq_ref[...] * qk_scale   # per-row Q scale, exp2 domain
    q_start = off_ref[0] + qi * block_q
    k_offset = off_ref[1]
    row_pos = q_start + jax.lax.broadcasted_iota(jnp.int32, (rows,), 0) % block_q

    def body(j, carry, masked):
        acc, m_prev, l_prev = carry
        k = k_ref[pl.ds(j * block_kv, block_kv), :]
        qk = dot(q, k, trans_b=True, out=jnp.int32).astype(jnp.float32)
        s = qk * (row_scale * sk_ref[j])[:, None]
        if masked:
            col_local = j * block_kv + jax.lax.broadcasted_iota(jnp.int32, (block_kv,), 0)
            mask = tile_mask(row_pos, col_local + k_offset, kv_len, causal, col_local)
            s = jnp.where(mask, s, MASK_VALUE)
        m_cur = jnp.max(s, axis=1)
        m_next = jnp.maximum(m_prev, m_cur)
        p = jnp.exp2(s - m_next[:, None])
        # per-row int8 P: the row's largest entry exp2(m_cur - m_next) -> 127
        inv = INT8_MAX / jnp.maximum(jnp.exp2(m_cur - m_next), _P_FLOOR)
        p_i8 = (p * inv[:, None] + 0.5).astype(jnp.int32).astype(jnp.int8)
        sp = 1.0 / inv
        v = v_ref[pl.ds(j * block_kv, block_kv), :]
        pv = dot(p_i8, v, out=jnp.int32).astype(jnp.float32)
        alpha = jnp.exp2(m_prev - m_next)
        l_next = l_prev * alpha + jnp.sum(p_i8.astype(jnp.float32), axis=1) * sp
        acc = acc * alpha[:, None] + pv * (sp * sv_ref[j])[:, None]
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


def _quantize_tiles(x: jnp.ndarray, block: int):
    """[n, t, d] (t a multiple of block) -> int8 payload + one absmax/127
    scale per (n, tile) [n, t / block]."""
    n, t, d = x.shape
    xb = x.astype(jnp.float32).reshape(n, t // block, block, d)
    s = jnp.maximum(jnp.max(jnp.abs(xb), axis=(2, 3)), _EPS) / INT8_MAX
    x_i8 = jnp.clip(jnp.round(xb / s[:, :, None, None]), -INT8_MAX, INT8_MAX)
    return x_i8.astype(jnp.int8).reshape(n, t, d), s


def quantize_qkv(q, k, v, config: BlockConfig, k_sub=None):
    """Per-tile int8 quantization of Q/K/V at the kernel's tile grain (plain
    jnp — XLA fuses it into one read and a quarter-width write).

    k_sub: optional [b, h_kv, 1, d] shift (the K-smoothing mean) subtracted
    from K before quantization.

    Returns ((q_i8, sq), (k_i8, sk), (v_i8, sv)): q in the kernel's folded
    layout [b·h_kv, n_q_tiles, group·block_q, d] with one scale per row
    (the scale of the row's (head, q tile)); k/v as [b·h_kv, padded_kv, d]
    with one scale per kv tile [b·h_kv, n_kv_tiles] — the residual set the
    backward reuses.
    """
    batch, head, q_tokens, head_dim = q.shape
    kv_head, kv_len = k.shape[1], k.shape[2]
    # the int8 backward tiles at this grain: rows capped for its shared memory
    config = config.for_group(head // kv_head, max_rows(head_dim))
    block_q, block_kv = config.block_q, config.block_kv
    bh = batch * head
    q_i8, sq = _quantize_tiles(
        pad_tokens(q.reshape(bh, q_tokens, head_dim), block_q, 1), block_q
    )
    padded_q = q_i8.shape[1]
    sq_rows = jnp.repeat(sq, block_q, axis=1)  # [bh, padded_q]
    q_i8 = fold_group(q_i8.reshape(batch, head, padded_q, head_dim), kv_head, block_q)
    sq_rows = fold_group(sq_rows.reshape(batch, head, padded_q), kv_head, block_q)
    k = k.astype(jnp.float32)
    if k_sub is not None:
        k = k - k_sub.astype(jnp.float32)
    bh_kv = batch * kv_head
    k_i8, sk = _quantize_tiles(pad_tokens(k.reshape(bh_kv, kv_len, head_dim), block_kv, 1), block_kv)
    v_i8, sv = _quantize_tiles(pad_tokens(v.reshape(bh_kv, kv_len, head_dim), block_kv, 1), block_kv)
    return (q_i8, sq_rows), (k_i8, sk), (v_i8, sv)


def residual_tiles(residuals, batch: int, head: int):
    """(block_q, block_kv) read off a residual set — the int8 family's
    tiling is pinned to its quantization grain."""
    (q_i8, _), (k_i8, sk), _ = residuals
    kv_head = k_i8.shape[0] // batch
    group = next_pow2(head // kv_head)
    return q_i8.shape[2] // group, k_i8.shape[1] // sk.shape[1]


@functools.partial(
    jax.jit, static_argnames=("causal", "sm_scale", "config", "interpret")
)
def int8_attention_fwd(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    k_sub: jnp.ndarray | None = None,
    interpret: bool | None = None,
):
    """INT8 attention forward on [b, h, t, d] inputs (k/v may carry fewer
    heads: GQA).

    k_sub: optional [b, h_kv, 1, d] K-smoothing mean subtracted before K is
    quantized. If omitted, K is quantized as given.

    Returns (o, lse, residuals) where residuals =
    ((q_i8, sq), (k_i8, sk), (v_i8, sv)) for the int8 backward.
    """
    batch, head, q_tokens, head_dim = q.shape
    kv_len = k.shape[2]
    if head % k.shape[1] != 0:
        raise ValueError(f"q heads ({head}) must be a multiple of kv heads ({k.shape[1]})")
    if config is None:
        config = default_block_config("int8", q_tokens, kv_len, head_dim)
    residuals = quantize_qkv(q, k, v, config, k_sub=k_sub)
    o, lse = int8_attention_fwd_from_quantized(
        residuals, (batch, head, q_tokens, kv_len, head_dim),
        causal=causal, sm_scale=sm_scale, config=config, interpret=interpret,
    )
    return o, lse, residuals


@functools.partial(
    jax.jit, static_argnames=("dims", "causal", "sm_scale", "config", "interpret")
)
def int8_attention_fwd_from_quantized(
    residuals,
    dims,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    interpret: bool | None = None,
    q_offset: jnp.ndarray | int = 0,
    k_offset: jnp.ndarray | int = 0,
):
    """Run the int8 forward from pre-quantized blocks (quantize_qkv's
    layout). The tiling is read off the residuals; `config` supplies the
    launch shape (warps, stages).

    q_offset/k_offset: global token positions of the local q / kv shards
    (causal masking across sequence shards)."""
    if interpret is None:
        interpret = use_interpret_mode()
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    batch, head, q_tokens, kv_len, head_dim = dims
    if config is None:
        config = default_block_config("int8", q_tokens, kv_len, head_dim)
    bh_kv, nq, rows, _ = q_i8.shape
    if k_i8.shape[0] != bh_kv:
        raise ValueError(f"q rows ({bh_kv}) and kv rows ({k_i8.shape[0]}) disagree")
    block_q, block_kv = residual_tiles(residuals, batch, head)
    padded_kv, nkv = k_i8.shape[1], sk.shape[1]
    _, qk_scale = qk_scales(head_dim, sm_scale)
    offsets = jnp.stack([jnp.asarray(q_offset, jnp.int32), jnp.asarray(k_offset, jnp.int32)])

    kernel = functools.partial(
        _int8_fwd_kernel, qk_scale=qk_scale, causal=causal, kv_len=kv_len,
        num_kv_blocks=nkv, block_q=block_q, block_kv=block_kv,
    )
    q_tile = pl.BlockSpec((None, None, rows, head_dim), lambda b, i: (b, i, 0, 0))
    row_tile = pl.BlockSpec((None, None, rows), lambda b, i: (b, i, 0))
    kv_all = pl.BlockSpec((None, padded_kv, head_dim), lambda b, i: (b, 0, 0))
    scale_all = pl.BlockSpec((None, nkv), lambda b, i: (b, 0))
    o, lse = triton_call(
        kernel,
        grid=(bh_kv, nq),
        in_specs=[pl.BlockSpec((2,), lambda b, i: (0,)), q_tile, row_tile,
                  kv_all, scale_all, kv_all, scale_all],
        out_specs=[q_tile, row_tile],
        out_shape=[
            jax.ShapeDtypeStruct((bh_kv, nq, rows, head_dim), jnp.float32),
            jax.ShapeDtypeStruct((bh_kv, nq, rows), jnp.float32),
        ],
        config=config,
        interpret=interpret,
        name="int8_fwd",
    )(offsets, q_i8, sq.astype(jnp.float32), k_i8, sk.astype(jnp.float32),
      v_i8, sv.astype(jnp.float32))
    return unfold_group(o, batch, head, q_tokens), unfold_group(lse, batch, head, q_tokens)
