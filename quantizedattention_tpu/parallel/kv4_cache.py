"""INT4-quantized KV cache + plain-JAX decode attention.

int4 payloads halve the int8 cache's device-memory FOOTPRINT — a CAPACITY
feature (2x the max context or live slots per card). Decode unpacks the
nibbles and runs kv_cache.dense_decode (plain jnp, XLA-compiled); a Hopper
kernel for it is listed in ROADMAP.md. The layout decisions of
parallel/kv_cache.py carry over: scales [b, h, max_len], GQA q groups
folded per kv head.

Packing: SPLIT-HALF PER 256-TOKEN PACK BLOCK. Byte row r of pack block B
(buffer row 128·B + r) holds token 256·B + r in its low nibble and token
256·B + 128 + r in its high nibble:
- a token's nibble position depends only on its own index, so appends
  read-modify-write exactly one byte row per token (no repacking);
- any ≤128 consecutive tokens touch distinct byte rows, so scatter writes
  never collide (writers chunk by 128).

Per-token scales are absmax/7 (vs the int8 cache's absmax/127): the only
accuracy cost is nibble-rounding, bounded per element by scale/2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quantizedattention_tpu.parallel.kv_cache import dense_decode
from quantizedattention_tpu.quantize.int4 import unpack_int4

PACK = 256  # tokens per pack block (128 byte rows)


class Int4KVCache(NamedTuple):
    """int4 KV cache: packed payloads [b, h_kv, max_len/2, d] (two tokens
    per byte, PACK-block split-half), scales [b, h_kv, max_len] f32."""

    k_p: jnp.ndarray
    sk: jnp.ndarray
    v_p: jnp.ndarray
    sv: jnp.ndarray
    length: jnp.ndarray  # [b] int32

    @property
    def max_len(self) -> int:
        return 2 * self.k_p.shape[2]


def init_kv4_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int) -> Int4KVCache:
    if max_len % PACK != 0:
        raise ValueError(f"max_len={max_len} must be a multiple of {PACK} (int4 pack blocks)")
    return Int4KVCache(
        k_p=jnp.zeros((batch, n_kv_heads, max_len // 2, head_dim), jnp.int8),
        sk=jnp.zeros((batch, n_kv_heads, max_len), jnp.float32),
        v_p=jnp.zeros((batch, n_kv_heads, max_len // 2, head_dim), jnp.int8),
        sv=jnp.zeros((batch, n_kv_heads, max_len), jnp.float32),
        length=jnp.zeros((batch,), jnp.int32),
    )


def _quant4_rows(x):
    """Per-token symmetric int4: (low nibbles [..., t, d] int8 in [0, 15],
    scales [..., t] f32). Values are two's-complement nibbles of
    clip(round(x/s), -8, 7)."""
    s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-12) / 7.0
    v = jnp.clip(jnp.round(x / s), -8.0, 7.0).astype(jnp.int8)
    return v & jnp.int8(0x0F), s[..., 0].astype(jnp.float32)


def _rows_nibbles(positions):
    """token positions [t] -> (byte rows [t], nibble index [t] 0=lo 1=hi)."""
    blk, r = positions // PACK, positions % PACK
    half = PACK // 2
    return blk * half + r % half, r // half


def _write_tokens_packed(buf, vals4, positions):
    """RMW-write nibbles for `positions` [t] (t <= 128, no row collisions)
    into buf [h, max_len/2, d]; vals4 [h, t, d] low nibbles."""
    rows, nib = _rows_nibbles(positions)
    cur = jnp.take(buf, rows, axis=1)  # [h, t, d]
    mask_hi = nib[None, :, None] == 1
    new = jnp.where(
        mask_hi,
        (cur & jnp.int8(0x0F)) | (vals4 << 4),  # int8 shift wraps: bits exact
        (cur & jnp.int8(~0x0F)) | vals4,
    )
    return buf.at[:, rows].set(new)


def _write_scales(sbuf, s, positions):
    """sbuf [h, max_len], s [h, t] at token `positions` [t]."""
    return sbuf.at[:, positions].set(s)


@jax.jit
def append_kv4(
    cache: Int4KVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray | None = None,
) -> Int4KVCache:
    """Quantize and append [b, h_kv, t_new, d] K/V at each row's length —
    the int4 twin of kv_cache.append_kv (same active-mask contract).
    t_new is chunked by 128 so packed-byte scatters never collide."""
    t_new = k_new.shape[2]
    k4, sk = _quant4_rows(k_new.astype(jnp.float32))
    v4, sv = _quant4_rows(v_new.astype(jnp.float32))

    def one_row(kbuf, skbuf, vbuf, svbuf, k4r, skr, v4r, svr, pos):
        for c0 in range(0, t_new, PACK // 2):
            c1 = min(c0 + PACK // 2, t_new)
            positions = pos + jnp.arange(c0, c1)
            kbuf = _write_tokens_packed(kbuf, k4r[:, c0:c1], positions)
            vbuf = _write_tokens_packed(vbuf, v4r[:, c0:c1], positions)
            skbuf = _write_scales(skbuf, skr[:, c0:c1], positions)
            svbuf = _write_scales(svbuf, svr[:, c0:c1], positions)
        return kbuf, skbuf, vbuf, svbuf

    k_p, sk_b, v_p, sv_b = jax.vmap(one_row)(
        cache.k_p, cache.sk, cache.v_p, cache.sv, k4, sk, v4, sv, cache.length
    )
    adv = t_new if active is None else t_new * active.astype(jnp.int32)
    return Int4KVCache(k_p, sk_b, v_p, sv_b, cache.length + adv)


@jax.jit
def install_kv4_batched(
    cache: Int4KVCache, k_new: jnp.ndarray, v_new: jnp.ndarray
) -> Int4KVCache:
    """Whole-prompt install into ALL-FRESH rows (every row at length 0 —
    prefill_batched's contract): one arithmetic lo|hi<<4 pack per pack
    block instead of append_kv4's t/128 read-modify-write rounds.
    k_new/v_new [b, h_kv, t, d]; every row's length becomes t."""
    b, h, t, d = k_new.shape
    tp = -(-t // PACK) * PACK
    pad = ((0, 0), (0, 0), (0, tp - t), (0, 0))
    k4, sk = _quant4_rows(jnp.pad(k_new.astype(jnp.float32), pad))
    v4, sv = _quant4_rows(jnp.pad(v_new.astype(jnp.float32), pad))

    def pack(v):  # [b, h, tp, d] nibbles -> [b, h, tp/2, d] bytes
        g = v.reshape(b, h, tp // PACK, PACK, d)
        return (g[:, :, :, : PACK // 2] | (g[:, :, :, PACK // 2 :] << 4)).reshape(
            b, h, tp // 2, d
        )

    return Int4KVCache(
        k_p=cache.k_p.at[:, :, : tp // 2].set(pack(k4)),
        sk=cache.sk.at[:, :, :tp].set(sk),
        v_p=cache.v_p.at[:, :, : tp // 2].set(pack(v4)),
        sv=cache.sv.at[:, :, :tp].set(sv),
        length=jnp.full((b,), t, jnp.int32),
    )


def write_kv4_slot(
    cache: Int4KVCache,
    slot: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    true_len: jnp.ndarray,
) -> Int4KVCache:
    """Fused-prefill install of [h_kv, t, d] K/V at batch row `slot` from
    position 0 (the int4 twin of kv_cache.write_kv_slot). t is padded to a
    PACK multiple, so the whole write packs arithmetically (lo | hi << 4)
    with no read-modify-write."""
    t = k_new.shape[1]
    tp = -(-t // PACK) * PACK
    pad = ((0, 0), (0, tp - t), (0, 0))
    k4, sk = _quant4_rows(jnp.pad(k_new.astype(jnp.float32), pad))
    v4, sv = _quant4_rows(jnp.pad(v_new.astype(jnp.float32), pad))

    def pack_aligned(v):  # [h, tp, d] nibbles -> [h, tp/2, d] bytes
        h, _, d = v.shape
        g = v.reshape(h, tp // PACK, PACK, d)
        return (g[:, :, : PACK // 2] | (g[:, :, PACK // 2 :] << 4)).reshape(
            h, tp // 2, d
        )

    def put(buf, val):
        val = val[:, : buf.shape[2]]
        return jax.lax.dynamic_update_slice(
            buf, val[None], (slot,) + (0,) * (buf.ndim - 1)
        )

    def fit_scale(s):
        if s.shape[1] < cache.max_len:
            s = jnp.pad(s, ((0, 0), (0, cache.max_len - s.shape[1])))
        return s[:, : cache.max_len]

    return Int4KVCache(
        k_p=put(cache.k_p, pack_aligned(k4)),
        sk=put(cache.sk, fit_scale(sk)),
        v_p=put(cache.v_p, pack_aligned(v4)),
        sv=put(cache.sv, fit_scale(sv)),
        length=cache.length.at[slot].set(true_len.astype(jnp.int32)),
    )


def write_kv4_chunk(
    cache: Int4KVCache,
    slot: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    start,
    new_len: jnp.ndarray,
) -> Int4KVCache:
    """Chunked-prefill write (the int4 twin of kv_cache.write_kv_chunk):
    quantize [h_kv, c, d] K/V and install them at (row `slot`, position
    `start`). Chunks are 128-aligned but PACK is 256, so half the chunks
    land in high nibbles — the RMW token writer handles both, in <=128
    collision-free pieces."""
    c = k_new.shape[1]
    k4, sk = _quant4_rows(k_new.astype(jnp.float32))
    v4, sv = _quant4_rows(v_new.astype(jnp.float32))
    start = jnp.asarray(start, jnp.int32)
    kbuf, skbuf = cache.k_p[slot], cache.sk[slot]
    vbuf, svbuf = cache.v_p[slot], cache.sv[slot]
    for c0 in range(0, c, PACK // 2):
        c1 = min(c0 + PACK // 2, c)
        positions = start + jnp.arange(c0, c1)
        kbuf = _write_tokens_packed(kbuf, k4[:, c0:c1], positions)
        vbuf = _write_tokens_packed(vbuf, v4[:, c0:c1], positions)
        skbuf = _write_scales(skbuf, sk[:, c0:c1], positions)
        svbuf = _write_scales(svbuf, sv[:, c0:c1], positions)
    return Int4KVCache(
        k_p=cache.k_p.at[slot].set(kbuf),
        sk=cache.sk.at[slot].set(skbuf),
        v_p=cache.v_p.at[slot].set(vbuf),
        sv=cache.sv.at[slot].set(svbuf),
        length=cache.length.at[slot].set(new_len.astype(jnp.int32)),
    )


def read_prefix_kv4(cache: Int4KVCache, slot: jnp.ndarray, n_tokens: int):
    """Dequantize the first `n_tokens` (static, 128-aligned) of row `slot`
    — the chunked-prefill prefix view (reads whole pack blocks, trims)."""
    np_blocks = -(-n_tokens // PACK)  # whole pack blocks, then trim
    half = PACK // 2
    p_k = cache.k_p[slot, :, : np_blocks * half]  # [h, rows, d]
    p_v = cache.v_p[slot, :, : np_blocks * half]

    def unpack_rows(p):
        h, rows, d = p.shape
        lo, hi = unpack_int4(p)
        lo = lo.reshape(h, np_blocks, half, d)
        hi = hi.reshape(h, np_blocks, half, d)
        return jnp.concatenate([lo, hi], axis=2).reshape(
            h, np_blocks * PACK, d
        ).astype(jnp.float32)[:, :n_tokens]

    k = unpack_rows(p_k) * cache.sk[slot, :, :n_tokens, None]
    v = unpack_rows(p_v) * cache.sv[slot, :, :n_tokens, None]
    return k, v


def _unpack_ordered(p):
    """Packed [b, h, max_len/2, d] -> int32 nibbles [b, h, max_len, d] in
    token order (within a pack block: [lo rows ; hi rows])."""
    b, h, half_l, d = p.shape
    lo, hi = unpack_int4(p)
    lo = lo.reshape(b, h, -1, PACK // 2, d)
    hi = hi.reshape(b, h, -1, PACK // 2, d)
    return jnp.concatenate([lo, hi], axis=3).reshape(b, h, 2 * half_l, d)


def dequantize_kv4(cache: Int4KVCache):
    """Unpack to f32 K/V [b, h, max_len, d] — the test oracle's view."""
    k = _unpack_ordered(cache.k_p).astype(jnp.float32) * cache.sk[..., None]
    v = _unpack_ordered(cache.v_p).astype(jnp.float32) * cache.sv[..., None]
    return k, v


def decode_attention_int4(
    q: jnp.ndarray,
    cache: Int4KVCache,
    sm_scale: float | None = None,
    return_lse: bool = False,
) -> jnp.ndarray:
    """Single-token decode against the int4 cache: q [b, n_q_heads, d]
    (GQA as in kv_cache.decode_attention). Returns o [b, H, d] f32, and
    the exp2-domain lse [b, H] with return_lse=True."""
    o, lse = _decode_int4(q, cache, sm_scale, 1)
    return (o, lse) if return_lse else o


def verify_decode_attention_int4(
    q: jnp.ndarray,
    cache: Int4KVCache,
    sm_scale: float | None = None,
) -> jnp.ndarray:
    """Speculative staircase verify over the int4 cache: q [b, H, s, d]
    (see kv_cache.verify_decode_attention — identical contract)."""
    b, n_q_heads, s, d = q.shape
    o, _ = _decode_int4(q.reshape(b, n_q_heads * s, d), cache, sm_scale, s)
    return o.reshape(b, n_q_heads, s, d)


@functools.partial(jax.jit, static_argnames=("sm_scale", "spec"))
def _decode_int4(q, cache: Int4KVCache, sm_scale, spec):
    n_kv = cache.k_p.shape[1]
    if q.shape[1] % (n_kv * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {n_kv} kv heads")
    return dense_decode(q, _unpack_ordered(cache.k_p), cache.sk,
                        _unpack_ordered(cache.v_p), cache.sv, cache.length,
                        sm_scale=sm_scale, spec=spec)
