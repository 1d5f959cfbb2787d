"""INT8-quantized KV cache + decode attention (serving path).

New capability vs the reference (no serving/inference layer exists there;
the north-star BASELINE.json demands a quantized KV-cache inference path).

Design: the cache stores int8 K/V payloads with *per-token* symmetric scales
(append-friendly — adding a token never re-scales old blocks). Decode at
serving batch is bound by memory traffic, so the win of int8 here is half
the bytes of bf16. Scales are stored [b, h, max_len]: the K scale applies
to the logits' token axis and the V scale folds into P before the PV dot,
so the int8 payloads enter the dots unscaled (exact in bf16).

Decode is plain jnp (`dense_decode`), compiled by XLA: a Triton split-kv
kernel (flash-decoding, one program per (batch·kv head, kv split)) was
measured against it on the H100 and lost — 53.7 vs 48.7 µs per decode step
at 8 slots x 32/8 heads x ctx 4096 x d=128 inside one jitted 64-step loop
(PERF.md) — so the kernel went. The same function serves the int4 and
paged caches after their unpack/gather.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.common import MASK_VALUE, qk_scales

_TILE = 128


class QuantizedKVCache(NamedTuple):
    """int8 KV cache: payload [b, h_kv, max_len, d], scales [b, h_kv, max_len]."""

    k_i8: jnp.ndarray
    sk: jnp.ndarray
    v_i8: jnp.ndarray
    sv: jnp.ndarray
    length: jnp.ndarray  # [b] int32, tokens filled per batch row

    @property
    def max_len(self) -> int:
        return self.k_i8.shape[2]


def init_kv_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int) -> QuantizedKVCache:
    if max_len % _TILE != 0:
        raise ValueError(f"max_len={max_len} must be a multiple of {_TILE} "
                         "(the engine's chunked prefill writes 128-token chunks)")
    return QuantizedKVCache(
        k_i8=jnp.zeros((batch, n_kv_heads, max_len, head_dim), jnp.int8),
        sk=jnp.zeros((batch, n_kv_heads, max_len), jnp.float32),
        v_i8=jnp.zeros((batch, n_kv_heads, max_len, head_dim), jnp.int8),
        sv=jnp.zeros((batch, n_kv_heads, max_len), jnp.float32),
        length=jnp.zeros((batch,), jnp.int32),
    )


def _row_quant(x):
    """Per-token symmetric int8: returns (x_i8 [..., t, d], scales [..., t])."""
    s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-12) / 127.0
    x_i8 = jnp.clip(jnp.round(x / s), -127.0, 127.0).astype(jnp.int8)
    return x_i8, s[..., 0].astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=())
def append_kv(
    cache: QuantizedKVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray | None = None,
) -> QuantizedKVCache:
    """Quantize and append [b, h_kv, t_new, d] keys/values at each row's length.

    active: optional [b] bool — rows where it is False do not advance
    `length` (continuous batching: idle slots ride along in the batched
    decode step without corrupting their cache; their masked write lands at
    the stale `length` position, which is past the row's logical end and
    invisible to the length-masked decode).
    """
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))

    def upd(buf, val, pos):
        # buf [h, max_len(, d)], val [h, t_new(, d)] — one batch row
        return jax.lax.dynamic_update_slice(buf, val, (0, pos) + (0,) * (buf.ndim - 2))

    t_new = k_new.shape[2]
    adv = t_new if active is None else t_new * active.astype(jnp.int32)
    return QuantizedKVCache(
        k_i8=jax.vmap(upd)(cache.k_i8, k_i8, cache.length),
        sk=jax.vmap(upd)(cache.sk, sk, cache.length),
        v_i8=jax.vmap(upd)(cache.v_i8, v_i8, cache.length),
        sv=jax.vmap(upd)(cache.sv, sv, cache.length),
        length=cache.length + adv,
    )


def write_kv_slot(
    cache: QuantizedKVCache,
    slot: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    true_len: jnp.ndarray,
) -> QuantizedKVCache:
    """Fused-prefill write: quantize [h_kv, t, d] K/V and install them at
    batch row `slot`, resetting the row's length to `true_len` (<= t; the
    tail beyond true_len is prompt padding, masked out by the decode).
    """
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))

    def put(buf, val):
        return jax.lax.dynamic_update_slice(
            buf, val[None], (slot,) + (0,) * (buf.ndim - 1)
        )

    # pad/trim the time axis to the cache's max_len before installing
    def fit(val):
        t = val.shape[1]
        if t < cache.max_len:
            widths = [(0, 0), (0, cache.max_len - t)] + [(0, 0)] * (val.ndim - 2)
            val = jnp.pad(val, widths)
        return val[:, : cache.max_len]

    return QuantizedKVCache(
        k_i8=put(cache.k_i8, fit(k_i8)),
        sk=put(cache.sk, fit(sk)),
        v_i8=put(cache.v_i8, fit(v_i8)),
        sv=put(cache.sv, fit(sv)),
        length=cache.length.at[slot].set(true_len.astype(jnp.int32)),
    )


def write_kv_chunk(
    cache: QuantizedKVCache,
    slot: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    start,
    new_len: jnp.ndarray,
) -> QuantizedKVCache:
    """Chunked-prefill write: quantize [h_kv, c, d] K/V and install them at
    (row `slot`, position `start`), setting the row length to `new_len`
    (chunked prefill appends prompt chunks left to right; the serving engine
    interleaves decode steps of OTHER slots between chunks)."""
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))
    start = jnp.asarray(start, jnp.int32)

    def put(buf, val):
        idx = (slot, jnp.int32(0), start) + (jnp.int32(0),) * (buf.ndim - 3)
        return jax.lax.dynamic_update_slice(buf, val[None], idx)

    return QuantizedKVCache(
        k_i8=put(cache.k_i8, k_i8),
        sk=put(cache.sk, sk),
        v_i8=put(cache.v_i8, v_i8),
        sv=put(cache.sv, sv),
        length=cache.length.at[slot].set(new_len.astype(jnp.int32)),
    )


def dense_decode(
    q: jnp.ndarray,
    k: jnp.ndarray,
    sk: jnp.ndarray,
    v: jnp.ndarray,
    sv: jnp.ndarray,
    length: jnp.ndarray,
    sm_scale: float | None = None,
    spec: int = 1,
):
    """Decode over an integer-payload cache in plain jnp (XLA): q [b, H, d]
    (H = n_kv · rows, rows = group · spec folded as r = g·spec + j) against
    k/v [b, n_kv, L, d] integer payloads with per-token scales sk/sv
    [b, n_kv, L] and live lengths [b].

    The K scale applies to the logits' token axis and the V scale folds
    into P, so the payloads enter the dots as bf16 (exact for int8 and
    int4 values) with f32 accumulation. Speculative verify (spec > 1): the
    j-th query of a group sits at position length - spec + j and attends
    keys at cols <= that position. Returns (o [b, H, d] f32, lse [b, H] in
    the exp2 domain, -inf for rows with no live key).
    """
    b, n_q, d = q.shape
    n_kv, L = k.shape[1], k.shape[2]
    rows = n_q // n_kv
    _, qk_scale = qk_scales(d, sm_scale)
    qg = q.astype(jnp.bfloat16).reshape(b, n_kv, rows, d)
    s = jnp.einsum("bhrd,bhtd->bhrt", qg, k.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    s = s * (sk.astype(jnp.float32) * qk_scale)[:, :, None, :]
    limit = length[:, None] - (spec - 1) + jnp.arange(rows)[None, :] % spec  # [b, rows]
    mask = jnp.arange(L)[None, None, None, :] < limit[:, None, :, None]
    s = jnp.where(mask, s, MASK_VALUE)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.where(mask, jnp.exp2(s - m), 0.0)
    l = jnp.sum(p, axis=-1)
    pv = jnp.einsum("bhrt,bhtd->bhrd",
                    (p * sv.astype(jnp.float32)[:, :, None, :]).astype(jnp.bfloat16),
                    v.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = pv / l_safe[..., None]
    lse = jnp.where(l == 0.0, -jnp.inf, m[..., 0] + jnp.log2(l_safe))
    return o.reshape(b, n_q, d), lse.reshape(b, n_q)


def decode_attention(
    q: jnp.ndarray,
    cache: QuantizedKVCache,
    sm_scale: float | None = None,
    return_lse: bool = False,
) -> jnp.ndarray:
    """Single-token decode: q [b, n_q_heads, d] against the int8 cache.

    Supports GQA (n_q_heads a multiple of the cache's n_kv_heads). Returns
    [b, n_q_heads, d] f32; with return_lse=True also the exp2-domain lse
    [b, n_q_heads] (-inf for rows with no live tokens) — the merge handle
    for sequence-sharded decode (context_sharded_decode).
    """
    o, lse = _decode(q, cache, sm_scale, 1)
    return (o, lse) if return_lse else o


def verify_decode_attention(
    q: jnp.ndarray,
    cache: QuantizedKVCache,
    sm_scale: float | None = None,
) -> jnp.ndarray:
    """Multi-position decode for speculative verification: q [b, H, s, d]
    holds s consecutive query positions per slot (the last accepted token
    followed by s-1 draft tokens), whose K/V must ALREADY be appended to
    the cache (row length includes all s). Query j sits at position
    length - s + j and attends keys at cols <= length - s + j — a causal
    staircase applied per folded q-row, so one dispatch verifies s
    positions instead of s dispatches (serve/spec.py).

    Returns [b, H, s, d] f32.
    """
    b, n_q_heads, s, d = q.shape
    # fold (group, spec) into the q-row axis: row r = g*s + j
    o, _ = _decode(q.reshape(b, n_q_heads * s, d), cache, sm_scale, s)
    return o.reshape(b, n_q_heads, s, d)


@functools.partial(jax.jit, static_argnames=("sm_scale", "spec"))
def _decode(q, cache: QuantizedKVCache, sm_scale, spec):
    n_kv = cache.k_i8.shape[1]
    if q.shape[1] % (n_kv * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {n_kv} kv heads")
    return dense_decode(q, cache.k_i8, cache.sk, cache.v_i8, cache.sv, cache.length,
                        sm_scale=sm_scale, spec=spec)


def shard_cache_context(cache: QuantizedKVCache, axis_name: str) -> QuantizedKVCache:
    """View a device's sequence shard of a context-sharded cache: the shard
    holds global token positions [idx*shard_len, (idx+1)*shard_len) and its
    local live-token count is the clipped remainder of the global length.
    Call inside shard_map on per-device values whose sequence axis is
    already the local shard."""
    idx = jax.lax.axis_index(axis_name)
    shard_len = cache.k_i8.shape[2]
    local_len = jnp.clip(cache.length - idx * shard_len, 0, shard_len)
    return cache._replace(length=local_len)


def context_sharded_decode(
    q: jnp.ndarray,
    cache: QuantizedKVCache,
    axis_name: str,
    sm_scale: float | None = None,
) -> jnp.ndarray:
    """Flash-decoding over a sequence-sharded KV cache — call inside
    shard_map.

    The cache's token axis is sharded on `axis_name` (each chip holds a
    contiguous slice of every sequence; `cache.length` is the GLOBAL length,
    replicated). Each chip decodes against its own slice — half the HBM
    traffic of bf16 thanks to the int8 payload, zero KV movement — and the
    normalized partials merge with three tiny collectives over the
    [b, n_q_heads] statistics:
        m  = pmax(lse);  w = exp2(lse − m);  O = psum(w·O) / psum(w).
    This is the decode-side counterpart of ring attention's training-side
    merge (parallel/ring.py), per the north-star's "KV tensor-sharding over
    a multi-host pod slice with quantized KV-cache".
    """
    from quantizedattention_tpu.parallel.collective import lse_weighted_merge

    local = shard_cache_context(cache, axis_name)
    o, lse = decode_attention(q, local, sm_scale=sm_scale, return_lse=True)
    return lse_weighted_merge(o, lse, axis_name)
