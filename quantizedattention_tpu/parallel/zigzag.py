"""Zigzag (striped) causal ring attention — load-balanced context parallelism.

The contiguous-shard causal ring (parallel/ring.py) is bound by its LAST
rank: rank i attends shards 0..i, so rank n-1 does ~n live hops while rank 0
does ~1/2 — the analytic model (parallel/scaling_model.py) caps contiguous
causal ring/all-gather efficiency near 0.5*(n+1)/(n-1/2) -> 50-60% at scale,
and the lax.cond hop-skipping saves energy but not wall-clock. The classic
fix (used by production context-parallel trainers) re-shards the sequence in
a ZIGZAG: split the global sequence into 2n equal chunks; device i owns
chunks (i, 2n-1-i). Then for every rank the causal work is IDENTICAL:

  * hop 0 (own shard): two aligned diagonal pieces (causal) + one full
    piece (the high chunk attends the whole low chunk);
  * every other hop (source shard s != i): EXACTLY two live full pieces —
    (q_hi vs k_lo^s) always, plus exactly one of (q_lo vs k_lo^s) [s < i]
    or (q_hi vs k_hi^s) [s > i]. The dead pieces are never computed: the
    second piece's operands are SELECTED by the s<i predicate (same shapes
    either way), so each hop runs exactly two [c x c] kernels on every
    rank — 2n+1 pieces per rank per layer, the balanced causal total.

Link traffic is the plain ring's (the kv pair of both chunks rotates:
same bytes as a contiguous shard of t_local tokens); the backward rides
dK/dV accumulators around the ring exactly like parallel/ring.py:137-190.

Data layout: callers shard the PERMUTED sequence — zigzag_perm(n, t) gives
the global token order such that contiguous shard_map shards hold each
device's (lo, hi) chunk pair; zigzag_local_positions recovers the global
RoPE positions inside shard_map. models/sharded_train.py wires this as
attention_sp="zigzag" (it permutes tokens/targets once per step; the
per-token LM loss is permutation-invariant).

No reference counterpart (the reference is single-GPU; SURVEY.md §2.4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized,
    quantize_qkv,
)
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config

_NEG_INF = -jnp.inf


def zigzag_perm(n: int, t: int) -> jnp.ndarray:
    """Global token order whose contiguous n-way split gives device i the
    chunk pair (i, 2n-1-i): [chunk_0, chunk_{2n-1}, chunk_1, chunk_{2n-2},
    ...]. Apply to tokens AND targets before sharding; inverse via argsort."""
    if t % (2 * n) != 0:
        raise ValueError(f"t={t} must be a multiple of 2n={2 * n}")
    c = t // (2 * n)
    chunks = []
    for i in range(n):
        chunks.append(jnp.arange(i * c, (i + 1) * c))
        chunks.append(jnp.arange((2 * n - 1 - i) * c, (2 * n - i) * c))
    return jnp.concatenate(chunks)


def zigzag_local_positions(idx, n: int, t_local: int) -> jnp.ndarray:
    """Global positions of device idx's local tokens (RoPE input): the low
    chunk [idx*c, (idx+1)*c) then the high chunk [(2n-1-idx)*c, ...)."""
    c = t_local // 2
    lo = idx * c + jnp.arange(c)
    hi = (2 * n - 1 - idx) * c + jnp.arange(c)
    return jnp.concatenate([lo, hi])


def _merge(o, lse, o_p, lse_p):
    """lse-weighted merge of normalized partials — ring's identity, reused
    (ring.py imports nothing from this module, so no cycle)."""
    from quantizedattention_tpu.parallel.ring import _merge_partials

    return _merge_partials(o, lse, o_p, lse_p)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def zigzag_ring_attention(q, k, v, axis_name, sm_scale=None,
                          config: BlockConfig | None = None):
    """Causal ring attention over zigzag-sharded inputs — call inside
    shard_map. q/k/v: local [b, h(_kv), t_local, d] where the local tokens
    are the device's (lo, hi) zigzag chunk pair (see zigzag_perm). GQA:
    unrepeated kv heads ride the ring. Returns the local O shard (f32)."""
    o, _ = _zz_fwd_impl(q, k, v, axis_name, sm_scale, config)
    return o


def _zz_fwd_impl(q, k, v, axis_name, sm_scale, config):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape
    c = t_local // 2
    if config is None:
        config = default_block_config("bf16", c, c, head_dim)
    config = config.clamp(c, c)  # piece kernels run on [c x c] chunks

    q_lo, q_hi = q[:, :, :c], q[:, :, c:]
    o_lo = jnp.zeros((batch, head, c, head_dim), jnp.float32)
    o_hi = jnp.zeros_like(o_lo)
    lse_lo = jnp.full((batch, head, c), _NEG_INF, jnp.float32)
    lse_hi = jnp.full_like(lse_lo, _NEG_INF)

    def attend(qc, kc, vc, causal):
        # GQA-native kernel: unrepeated kv chunks go straight in
        return flash_attention_fwd(
            qc, kc, vc, causal=causal, sm_scale=sm_scale, config=config,
        )

    kv = (k[:, :, :c], k[:, :, c:], v[:, :, :c], v[:, :, c:])
    for step in range(n):
        kv_next = (
            jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm), kv)
            if step < n - 1 else None
        )
        k_lo, k_hi, v_lo, v_hi = kv
        if step == 0:
            # own shard: two aligned diagonals + (hi attends all of lo)
            o_p, l_p = attend(q_lo, k_lo, v_lo, True)
            o_lo, lse_lo = _merge(o_lo, lse_lo, o_p, l_p)
            o_p, l_p = attend(q_hi, k_hi, v_hi, True)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
            o_p, l_p = attend(q_hi, k_lo, v_lo, False)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
        else:
            src = (idx - step) % n
            lo_side = src < idx  # which second piece is live
            # piece A — always live: q_hi attends the source's LOW chunk
            # (chunk id src < 2n-1-idx for every src in [0, n))
            o_p, l_p = attend(q_hi, k_lo, v_lo, False)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
            # piece B — operand-selected: (q_lo vs k_lo^src) when src < idx,
            # else (q_hi vs k_hi^src); both are full [c x c] attentions, so
            # ONE kernel runs either way (no dead compute, perfect balance)
            qc = jnp.where(lo_side, q_lo, q_hi)
            kc = jnp.where(lo_side, k_lo, k_hi)
            vc = jnp.where(lo_side, v_lo, v_hi)
            o_p, l_p = attend(qc, kc, vc, False)
            o_lo2, lse_lo2 = _merge(o_lo, lse_lo, o_p, l_p)
            o_hi2, lse_hi2 = _merge(o_hi, lse_hi, o_p, l_p)
            o_lo = jnp.where(lo_side, o_lo2, o_lo)
            lse_lo = jnp.where(lo_side, lse_lo2, lse_lo)
            o_hi = jnp.where(lo_side, o_hi, o_hi2)
            lse_hi = jnp.where(lo_side, lse_hi, lse_hi2)
        if kv_next is not None:
            kv = kv_next

    o = jnp.concatenate([o_lo, o_hi], axis=2)
    lse = jnp.concatenate([lse_lo, lse_hi], axis=2)
    return o, lse


def _zz_fwd(q, k, v, axis_name, sm_scale, config):
    o, lse = _zz_fwd_impl(q, k, v, axis_name, sm_scale, config)
    return o, (q, k, v, o, lse)


def _zz_bwd(axis_name, sm_scale, config, res, do):
    q, k, v, o, lse = res
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape
    c = t_local // 2
    if config is None:
        config = default_block_config("bf16", c, c, head_dim)
    config = config.clamp(c, c)

    q_lo, q_hi = q[:, :, :c], q[:, :, c:]
    o_lo, o_hi = o[:, :, :c], o[:, :, c:]
    lse_lo, lse_hi = lse[:, :, :c], lse[:, :, c:]
    do_lo, do_hi = do[:, :, :c], do[:, :, c:]

    def grads(qc, oc, lc, dc, kc, vc, causal):
        # GQA-native backward: dk/dv come back kv-head shaped
        return flash_attention_bwd(
            qc, kc, vc, oc, lc, dc,
            causal=causal, sm_scale=sm_scale, config=config, fast=True,
        )

    dq_lo = jnp.zeros((batch, head, c, head_dim), jnp.float32)
    dq_hi = jnp.zeros_like(dq_lo)
    zero_kv = jnp.zeros((batch, k.shape[1], c, head_dim), jnp.float32)
    # dK/dV accumulators ride the ring WITH their chunk pair (ring.py:150):
    # the kv chunks rotate BEFORE the step's kernels (the transfer overlaps
    # compute — they don't depend on it), the accumulators after.
    kv = (k[:, :, :c], k[:, :, c:], v[:, :, :c], v[:, :, c:])
    dk_lo, dk_hi, dv_lo, dv_hi = zero_kv, zero_kv, zero_kv, zero_kv
    for step in range(n):
        kv_next = (
            jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm), kv)
            if step < n - 1 else None
        )
        k_lo, k_hi, v_lo, v_hi = kv
        if step == 0:
            dq_p, dk_p, dv_p = grads(q_lo, o_lo, lse_lo, do_lo, k_lo, v_lo, True)
            dq_lo += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
            dq_p, dk_p, dv_p = grads(q_hi, o_hi, lse_hi, do_hi, k_hi, v_hi, True)
            dq_hi += dq_p
            dk_hi += dk_p
            dv_hi += dv_p
            dq_p, dk_p, dv_p = grads(q_hi, o_hi, lse_hi, do_hi, k_lo, v_lo, False)
            dq_hi += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
        else:
            src = (idx - step) % n
            lo_side = src < idx
            dq_p, dk_p, dv_p = grads(q_hi, o_hi, lse_hi, do_hi, k_lo, v_lo, False)
            dq_hi += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
            qc = jnp.where(lo_side, q_lo, q_hi)
            oc = jnp.where(lo_side, o_lo, o_hi)
            lc = jnp.where(lo_side, lse_lo, lse_hi)
            dc = jnp.where(lo_side, do_lo, do_hi)
            kc = jnp.where(lo_side, k_lo, k_hi)
            vc = jnp.where(lo_side, v_lo, v_hi)
            dq_p, dk_p, dv_p = grads(qc, oc, lc, dc, kc, vc, False)
            dq_lo = dq_lo + jnp.where(lo_side, dq_p, 0.0)
            dq_hi = dq_hi + jnp.where(lo_side, 0.0, dq_p)
            dk_lo = dk_lo + jnp.where(lo_side, dk_p, 0.0)
            dk_hi = dk_hi + jnp.where(lo_side, 0.0, dk_p)
            dv_lo = dv_lo + jnp.where(lo_side, dv_p, 0.0)
            dv_hi = dv_hi + jnp.where(lo_side, 0.0, dv_p)
        if kv_next is not None:
            dk_lo, dk_hi, dv_lo, dv_hi = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm),
                (dk_lo, dk_hi, dv_lo, dv_hi))
            kv = kv_next

    # the accumulators sit one hop before home after n-1 rotations
    dk_lo, dk_hi, dv_lo, dv_hi = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, axis_name, perm),
        (dk_lo, dk_hi, dv_lo, dv_hi))
    dq = jnp.concatenate([dq_lo, dq_hi], axis=2)
    dk = jnp.concatenate([dk_lo, dk_hi], axis=2)
    dv = jnp.concatenate([dv_lo, dv_hi], axis=2)
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


zigzag_ring_attention.defvjp(_zz_fwd, _zz_bwd)


# ---------------------------------------------------------------------------
# int8 zigzag: the striped causal ring rotating QUANTIZED chunk pairs
# (payloads + per-block scales — the ring.py int8 contract, striped).
# ---------------------------------------------------------------------------

def _sel_res(cond, res_a, res_b):
    """Select an int8 (payload, scales) residual pair by a scalar predicate
    (the piece-B operand selection — one kernel runs either way)."""
    (pa, sa), (pb, sb) = res_a, res_b
    return (jnp.where(cond, pa, pb), jnp.where(cond, sa, sb))


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def zigzag_ring_attention_int8(q, k, v, axis_name, sm_scale=None,
                               config: BlockConfig | None = None):
    """int8 variant of zigzag_ring_attention: each chunk quantizes once
    (K smoothed with the GLOBAL token mean via pmean), the int8 payloads +
    scales rotate (~1/2 the bf16 wire bytes), and the backward re-rotates
    the same residuals into the int8 backward kernels — ring.py's
    residual-reuse contract, striped for causal load balance."""
    o, _ = _zz_i8_fwd_impl(q, k, v, axis_name, sm_scale, config)
    return o


def _zz_i8_quantize(q, k, v, c, config, k_mean):
    """Quantize the (lo, hi) chunk pairs independently at the chunk grain."""
    q_res_lo, k_res_lo, v_res_lo = quantize_qkv(
        q[:, :, :c], k[:, :, :c], v[:, :, :c], config, k_sub=k_mean)
    q_res_hi, k_res_hi, v_res_hi = quantize_qkv(
        q[:, :, c:], k[:, :, c:], v[:, :, c:], config, k_sub=k_mean)
    return (q_res_lo, q_res_hi), (k_res_lo, k_res_hi), (v_res_lo, v_res_hi)


def _zz_i8_fwd_impl(q, k, v, axis_name, sm_scale, config):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape
    c = t_local // 2
    if config is None:
        config = default_block_config("int8", c, c, head_dim)
    config = config.clamp(c, c)
    dims = (batch, head, c, c, head_dim)

    k_mean = jax.lax.pmean(jnp.mean(k, axis=-2, keepdims=True), axis_name)
    (q_lo_r, q_hi_r), (k_lo_r0, k_hi_r0), (v_lo_r0, v_hi_r0) = _zz_i8_quantize(
        q, k, v, c, config, k_mean)

    o_lo = jnp.zeros((batch, head, c, head_dim), jnp.float32)
    o_hi = jnp.zeros_like(o_lo)
    lse_lo = jnp.full((batch, head, c), _NEG_INF, jnp.float32)
    lse_hi = jnp.full_like(lse_lo, _NEG_INF)

    def attend(q_res, k_res, v_res, causal):
        # GQA-native kernel: unrepeated int8 payloads + scales go in
        return int8_attention_fwd_from_quantized(
            (q_res, k_res, v_res),
            dims, causal=causal, sm_scale=sm_scale, config=config,
        )

    kv = (k_lo_r0, k_hi_r0, v_lo_r0, v_hi_r0)
    for step in range(n):
        kv_next = (
            jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm), kv)
            if step < n - 1 else None
        )
        k_lo_r, k_hi_r, v_lo_r, v_hi_r = kv
        if step == 0:
            o_p, l_p = attend(q_lo_r, k_lo_r, v_lo_r, True)
            o_lo, lse_lo = _merge(o_lo, lse_lo, o_p, l_p)
            o_p, l_p = attend(q_hi_r, k_hi_r, v_hi_r, True)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
            o_p, l_p = attend(q_hi_r, k_lo_r, v_lo_r, False)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
        else:
            src = (idx - step) % n
            lo_side = src < idx
            o_p, l_p = attend(q_hi_r, k_lo_r, v_lo_r, False)
            o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, l_p)
            q_res = _sel_res(lo_side, q_lo_r, q_hi_r)
            k_res = _sel_res(lo_side, k_lo_r, k_hi_r)
            v_res = _sel_res(lo_side, v_lo_r, v_hi_r)
            o_p, l_p = attend(q_res, k_res, v_res, False)
            o_lo2, lse_lo2 = _merge(o_lo, lse_lo, o_p, l_p)
            o_hi2, lse_hi2 = _merge(o_hi, lse_hi, o_p, l_p)
            o_lo = jnp.where(lo_side, o_lo2, o_lo)
            lse_lo = jnp.where(lo_side, lse_lo2, lse_lo)
            o_hi = jnp.where(lo_side, o_hi, o_hi2)
            lse_hi = jnp.where(lo_side, lse_hi, lse_hi2)
        if kv_next is not None:
            kv = kv_next

    o = jnp.concatenate([o_lo, o_hi], axis=2)
    lse = jnp.concatenate([lse_lo, lse_hi], axis=2)
    res = ((q_lo_r, q_hi_r), (k_lo_r0, k_hi_r0), (v_lo_r0, v_hi_r0),
           k_mean, o, lse)
    return o, res


def _zz_i8_fwd(q, k, v, axis_name, sm_scale, config):
    o, res = _zz_i8_fwd_impl(q, k, v, axis_name, sm_scale, config)
    # rank-0 dtype markers (a (0,)-shaped mark under this grad-of-
    # shard_map path trips an XLA output-sharding assertion)
    marks = tuple(jnp.zeros((), x.dtype) for x in (q, k, v))
    return o, res + (marks,)


def _zz_i8_bwd(axis_name, sm_scale, config, res, do):
    (q_lo_r, q_hi_r), (k_lo_r0, k_hi_r0), (v_lo_r0, v_hi_r0), k_mean, o, lse, marks = res
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = o.shape
    c = t_local // 2
    h_kv = k_lo_r0[0].shape[0] // batch
    if config is None:
        config = default_block_config("int8", c, c, head_dim)
    config = config.clamp(c, c)
    dims = (batch, head, c, c, head_dim)

    o_lo, o_hi = o[:, :, :c], o[:, :, c:]
    lse_lo, lse_hi = lse[:, :, :c], lse[:, :, c:]
    do_lo, do_hi = do[:, :, :c], do[:, :, c:]

    def grads(q_res, oc, lc, dc, k_res, v_res, causal):
        # GQA-native backward: unrepeated residuals in, kv-head grads out
        return int8_attention_bwd(
            (q_res, k_res, v_res),
            k_mean, oc, lc, dc, dims,
            causal=causal, sm_scale=sm_scale, config=config,
        )

    dq_lo = jnp.zeros((batch, head, c, head_dim), jnp.float32)
    dq_hi = jnp.zeros_like(dq_lo)
    zero_kv = jnp.zeros((batch, h_kv, c, head_dim), jnp.float32)
    kv = (k_lo_r0, k_hi_r0, v_lo_r0, v_hi_r0)
    dk_lo, dk_hi, dv_lo, dv_hi = zero_kv, zero_kv, zero_kv, zero_kv
    for step in range(n):
        kv_next = (
            jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm), kv)
            if step < n - 1 else None
        )
        k_lo_r, k_hi_r, v_lo_r, v_hi_r = kv
        if step == 0:
            dq_p, dk_p, dv_p = grads(q_lo_r, o_lo, lse_lo, do_lo, k_lo_r, v_lo_r, True)
            dq_lo += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
            dq_p, dk_p, dv_p = grads(q_hi_r, o_hi, lse_hi, do_hi, k_hi_r, v_hi_r, True)
            dq_hi += dq_p
            dk_hi += dk_p
            dv_hi += dv_p
            dq_p, dk_p, dv_p = grads(q_hi_r, o_hi, lse_hi, do_hi, k_lo_r, v_lo_r, False)
            dq_hi += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
        else:
            src = (idx - step) % n
            lo_side = src < idx
            dq_p, dk_p, dv_p = grads(q_hi_r, o_hi, lse_hi, do_hi, k_lo_r, v_lo_r, False)
            dq_hi += dq_p
            dk_lo += dk_p
            dv_lo += dv_p
            q_res = _sel_res(lo_side, q_lo_r, q_hi_r)
            k_res = _sel_res(lo_side, k_lo_r, k_hi_r)
            v_res = _sel_res(lo_side, v_lo_r, v_hi_r)
            oc = jnp.where(lo_side, o_lo, o_hi)
            lc = jnp.where(lo_side, lse_lo, lse_hi)
            dc = jnp.where(lo_side, do_lo, do_hi)
            dq_p, dk_p, dv_p = grads(q_res, oc, lc, dc, k_res, v_res, False)
            dq_lo = dq_lo + jnp.where(lo_side, dq_p, 0.0)
            dq_hi = dq_hi + jnp.where(lo_side, 0.0, dq_p)
            dk_lo = dk_lo + jnp.where(lo_side, dk_p, 0.0)
            dk_hi = dk_hi + jnp.where(lo_side, 0.0, dk_p)
            dv_lo = dv_lo + jnp.where(lo_side, dv_p, 0.0)
            dv_hi = dv_hi + jnp.where(lo_side, 0.0, dv_p)
        if kv_next is not None:
            dk_lo, dk_hi, dv_lo, dv_hi = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name, perm),
                (dk_lo, dk_hi, dv_lo, dv_hi))
            kv = kv_next

    dk_lo, dk_hi, dv_lo, dv_hi = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, axis_name, perm),
        (dk_lo, dk_hi, dv_lo, dv_hi))
    dq = jnp.concatenate([dq_lo, dq_hi], axis=2)
    dk = jnp.concatenate([dk_lo, dk_hi], axis=2)
    dv = jnp.concatenate([dv_lo, dv_hi], axis=2)
    qm, km, vm = marks
    return dq.astype(qm.dtype), dk.astype(km.dtype), dv.astype(vm.dtype)


zigzag_ring_attention_int8.defvjp(_zz_i8_fwd, _zz_i8_bwd)


def make_zigzag_attention(
    mesh,
    kind: str = "bf16",
    sm_scale=None,
    config: BlockConfig | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str = "context",
):
    """Jitted zigzag causal attention on GLOBAL (unpermuted) [b, h, t, d]
    arrays — batch on data, heads on model, sequence on context. Handles
    the zigzag permutation and its inverse internally, so it is a drop-in
    swap for make_ring_attention(causal=True); differentiable (the
    permutation gathers transpose to scatters under AD). Causal only —
    non-causal attention has no imbalance for the stripes to fix."""
    import jax.numpy as _jnp
    from jax.sharding import PartitionSpec as P

    n = int(mesh.shape[context_axis])
    spec = P(data_axis, model_axis, context_axis, None)
    zz = zigzag_ring_attention_int8 if kind == "int8" else zigzag_ring_attention

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False,
    )
    def sharded(q, k, v):
        return zz(q, k, v, context_axis, sm_scale=sm_scale, config=config)

    fn = jax.jit(sharded)

    def apply(q, k, v):
        perm = zigzag_perm(n, q.shape[2])
        inv = _jnp.argsort(perm)
        o = fn(q[:, :, perm], k[:, :, perm], v[:, :, perm])
        return o[:, :, inv]

    return apply
