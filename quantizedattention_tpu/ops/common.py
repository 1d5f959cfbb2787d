"""Shared kernel helpers: masks, scaling constants, padding, GQA row folding,
causal loop bounds and the Triton-route call wrapper."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from quantizedattention_tpu.utils.runtime import next_pow2

# Large-negative fill for masked logits. Finite (not -inf) so that
# exp2(mask - mask) never produces NaN, and far enough below any real scaled
# logit that exp2 underflows to exactly 0 in f32. The reference used bf16
# -126 *before* scaling (attention_bf16.py:228), which leaks ~2^-22 of
# probability mass per masked key; we mask after scaling with a value that
# underflows exactly. (bf16(-30000) == -29952, still fine.)
MASK_VALUE = -30000.0

# 1/ln(2): converts natural-log-domain softmax to the exp2 domain the
# reference kernels use (attention_bf16.py:188-193).
LOG2_E = 1.44269504


def qk_scales(head_dim: int, sm_scale: float | None):
    """(sm_scale, qk_scale): natural-domain and exp2-domain logit scales."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    return sm_scale, sm_scale * LOG2_E


def tile_mask(row_pos, col_pos, kv_len: int, causal: bool, col_local=None):
    """Boolean [rows, cols] mask: True where the logit is valid.

    row_pos [rows] / col_pos [cols] are *global* token positions (they
    include any sequence-shard offset, so causal stays correct under ring /
    context parallelism); `col_local` [cols] is the position within the
    local shard, against which the shard's own padding (kv_len) is masked.
    Standard causal `k <= q` (divergence from the reference's strict
    `k < q`, SURVEY.md §2.3 Q6).
    """
    if col_local is None:
        col_local = col_pos
    mask = (col_local < kv_len)[None, :]
    if causal:
        mask = jnp.logical_and(mask, col_pos[None, :] <= row_pos[:, None])
    return mask


def pad_tokens(x: jnp.ndarray, block: int, axis: int) -> jnp.ndarray:
    """Zero-pad `axis` up to a multiple of `block`."""
    size = x.shape[axis]
    pad = (-size) % block
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def fold_group(x: jnp.ndarray, kv_head: int, block_q: int) -> jnp.ndarray:
    """[b, h, t, ...] -> [b·h_kv, n_q_blocks, group·block_q, ...].

    GQA row folding: the q heads that share one kv head are laid side by
    side in the rows of each q tile, so one dot per kv tile serves the
    whole group (Triton's dot takes no batch dimension). The group is
    padded to a power of two with zero heads and t to a multiple of
    block_q; row r of a tile is head g = r // block_q at token
    tile_start + r % block_q.
    """
    b, h, t = x.shape[:3]
    rest = x.shape[3:]
    rep = h // kv_head
    group = next_pow2(rep)
    x = x.reshape(b * kv_head, rep, t, *rest)
    if group != rep:
        x = jnp.pad(x, [(0, 0), (0, group - rep)] + [(0, 0)] * (x.ndim - 2))
    x = pad_tokens(x, block_q, 2)
    nq = x.shape[2] // block_q
    x = x.reshape(b * kv_head, group, nq, block_q, *rest)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape(b * kv_head, nq, group * block_q, *rest)


def unfold_group(x: jnp.ndarray, batch: int, head: int, t: int) -> jnp.ndarray:
    """Inverse of fold_group: [b·h_kv, nq, group·block_q, ...] -> [b, h, t, ...]."""
    bh_kv, nq, rows = x.shape[:3]
    rest = x.shape[3:]
    kv_head = bh_kv // batch
    rep = head // kv_head
    group = next_pow2(rep)
    block_q = rows // group
    x = x.reshape(bh_kv, nq, group, block_q, *rest)
    x = jnp.moveaxis(x, 2, 1).reshape(bh_kv, group, nq * block_q, *rest)
    return x[:, :rep, :t].reshape(batch, head, t, *rest)


def causal_kv_bounds(q_start, k_offset, block_q: int, block_kv: int,
                     kv_len: int, num_kv_blocks: int, causal: bool):
    """(n_clean, n_live): kv tiles [0, n_clean) need no mask at all (below
    the diagonal for every row and inside kv_len); tiles [n_clean, n_live)
    need the mask; tiles past n_live hold no valid key for any row and are
    skipped. Global positions: rows start at q_start, keys at k_offset."""
    n_unpadded = kv_len // block_kv
    if not causal:
        return n_unpadded, num_kv_blocks
    last_row = q_start + block_q - 1 - k_offset
    n_live = jnp.minimum((jnp.maximum(last_row, -1) + block_kv) // block_kv, num_kv_blocks)
    first_row = q_start - k_offset + 1
    n_clean = jnp.minimum(jnp.maximum(first_row, 0) // block_kv, n_unpadded)
    return jnp.minimum(n_clean, n_live), n_live


def dot(a, b, *, trans_a=False, trans_b=False, out=jnp.float32):
    """2-D matrix product for kernel bodies on the tensor cores: float
    operands are rounded to bf16 and accumulate in f32; int8 operands
    accumulate in int32 (pass out=jnp.int32). (IEEE-f32 dots on the Triton
    route run on the CUDA cores and lost to XLA on the card — PERF.md — so
    the exact-f32 modes are plain JAX, ops/plain.py.)"""
    if a.dtype != jnp.int8:
        a = a.astype(jnp.bfloat16)
        b = b.astype(jnp.bfloat16)
    dims = (((0,) if trans_a else (1,), (1,) if trans_b else (0,)), ((), ()))
    return jax.lax.dot_general(a, b, dims, preferred_element_type=out)


def triton_call(kernel, *, grid, in_specs, out_specs, out_shape, config,
                interpret: bool, name: str):
    """pl.pallas_call on the Triton route with the config's launch shape."""
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=config.num_warps, num_stages=config.num_stages
        ),
        interpret=interpret,
        name=name,
    )
