"""Paged INT4 KV cache + plain-JAX paged decode attention.

Completes the serving quantization matrix: the paged cache
(parallel/paged_cache.py — vLLM-style page-table gather) with the int4
payload format of the slotted int4 cache (parallel/kv4_cache.py). Each
page holds K/V at HALF the int8 page's bytes — a page-pool CAPACITY
feature (2x the pages per card). Decode gathers the pages, unpacks the
nibbles and runs kv_cache.dense_decode (plain jnp, XLA-compiled).

Packing: SPLIT-HALF PER PAGE. Byte row r of a page (payload rows
page_size/2) holds the page's token r in its low nibble and token
r + page_size/2 in its high nibble — the per-page instance of the
kv4_cache pack-block layout: single-byte-row RMW appends, and
collision-free scatters for any <= page_size/2 consecutive tokens.

Scales stay per-token f32 [n_pages, h, page_size] exactly as the int8
paged cache.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quantizedattention_tpu.parallel.kv4_cache import _quant4_rows
from quantizedattention_tpu.parallel.kv_cache import dense_decode
from quantizedattention_tpu.quantize.int4 import unpack_int4

_PAGE_TILE = 128


class Paged4KVCache(NamedTuple):
    k_p: jnp.ndarray       # [h_kv, n_pages, page_size/2, d] int8 (nibbles)
    sk: jnp.ndarray        # [n_pages, h_kv, page_size] f32
    v_p: jnp.ndarray       # [h_kv, n_pages, page_size/2, d] int8
    sv: jnp.ndarray        # [n_pages, h_kv, page_size] f32
    page_table: jnp.ndarray  # [n_seqs, max_pages] int32
    lengths: jnp.ndarray   # [n_seqs] int32

    @property
    def page_size(self) -> int:
        return 2 * self.k_p.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_p.shape[1]


def init_paged4_cache(
    n_kv_heads: int,
    n_pages: int,
    n_seqs: int,
    max_pages_per_seq: int,
    head_dim: int,
    page_size: int = 128,
) -> Paged4KVCache:
    if page_size % _PAGE_TILE != 0:
        raise ValueError(f"page_size={page_size} must be a multiple of {_PAGE_TILE}")
    return Paged4KVCache(
        k_p=jnp.zeros((n_kv_heads, n_pages, page_size // 2, head_dim), jnp.int8),
        sk=jnp.zeros((n_pages, n_kv_heads, page_size), jnp.float32),
        v_p=jnp.zeros((n_kv_heads, n_pages, page_size // 2, head_dim), jnp.int8),
        sv=jnp.zeros((n_pages, n_kv_heads, page_size), jnp.float32),
        page_table=jnp.zeros((n_seqs, max_pages_per_seq), jnp.int32),
        lengths=jnp.zeros((n_seqs,), jnp.int32),
    )


@jax.jit
def assign_pages4(cache: Paged4KVCache, seq: jnp.ndarray, pages: jnp.ndarray) -> Paged4KVCache:
    """Install a host-allocated page list for `seq`; reset its length."""
    return cache._replace(
        page_table=cache.page_table.at[seq].set(pages.astype(jnp.int32)),
        lengths=cache.lengths.at[seq].set(0),
    )


def _pack_pages(v4: jnp.ndarray, ps: int) -> jnp.ndarray:
    """[h, t, d] nibbles (t a multiple of ps) -> [h, t/ps, ps/2, d] bytes,
    split-half per page."""
    h, t, d = v4.shape
    g = v4.reshape(h, t // ps, ps, d)
    return g[:, :, : ps // 2] | (g[:, :, ps // 2 :] << 4)


@functools.partial(jax.jit, donate_argnums=(0,))
def write_prompt_paged4(
    cache: Paged4KVCache,
    seq: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    true_len: jnp.ndarray,
) -> Paged4KVCache:
    """Prefill: quantize [h, t_pad, d] K/V (t_pad a multiple of page_size),
    pack arithmetically per page (no RMW — whole pages), scatter into the
    pages `seq` owns; set length = true_len."""
    h, t_pad, d = k_new.shape
    ps = cache.page_size
    n_prompt_pages = t_pad // ps
    k4, sk = _quant4_rows(k_new.astype(jnp.float32))
    v4, sv = _quant4_rows(v_new.astype(jnp.float32))
    pages = jax.lax.dynamic_slice(
        cache.page_table[seq], (0,), (min(n_prompt_pages, cache.page_table.shape[1]),)
    )
    kp = _pack_pages(k4, ps)
    vp = _pack_pages(v4, ps)
    sk = sk.reshape(h, n_prompt_pages, ps).swapaxes(0, 1)
    sv = sv.reshape(h, n_prompt_pages, ps).swapaxes(0, 1)
    return cache._replace(
        k_p=cache.k_p.at[:, pages].set(kp),
        sk=cache.sk.at[pages].set(sk),
        v_p=cache.v_p.at[:, pages].set(vp),
        sv=cache.sv.at[pages].set(sv),
        lengths=cache.lengths.at[seq].set(true_len.astype(jnp.int32)),
    )


def write_chunk_paged4(
    cache: Paged4KVCache,
    seq: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    page_start: int,
    new_len: jnp.ndarray,
) -> Paged4KVCache:
    """Chunked prefill: [h, c, d] K/V (c a multiple of page_size) into the
    pages at table columns [page_start, ...); set length = new_len."""
    h, c, d = k_new.shape
    ps = cache.page_size
    n_chunk_pages = c // ps
    k4, sk = _quant4_rows(k_new.astype(jnp.float32))
    v4, sv = _quant4_rows(v_new.astype(jnp.float32))
    pages = jax.lax.dynamic_slice(
        cache.page_table[seq], (page_start,), (n_chunk_pages,)
    )
    return cache._replace(
        k_p=cache.k_p.at[:, pages].set(_pack_pages(k4, ps)),
        sk=cache.sk.at[pages].set(sk.reshape(h, n_chunk_pages, ps).swapaxes(0, 1)),
        v_p=cache.v_p.at[:, pages].set(_pack_pages(v4, ps)),
        sv=cache.sv.at[pages].set(sv.reshape(h, n_chunk_pages, ps).swapaxes(0, 1)),
        lengths=cache.lengths.at[seq].set(new_len.astype(jnp.int32)),
    )


def _unpack_page(p: jnp.ndarray):
    """[..., ps/2, d] bytes -> [..., ps, d] int32 nibbles in token order
    (one contiguous concat along the token axis; shared nibble decode —
    quantize/int4.py)."""
    lo, hi = unpack_int4(p)
    return jnp.concatenate([lo, hi], axis=-2)


def read_prefix_paged4(cache: Paged4KVCache, seq: jnp.ndarray, n_tokens: int):
    """Gather + dequantize the first `n_tokens` (static, a multiple of
    page_size) of `seq` — the chunked-prefill prefix view."""
    ps = cache.page_size
    n_pre = n_tokens // ps
    pages = cache.page_table[seq][:n_pre]
    h = cache.k_p.shape[0]
    d = cache.k_p.shape[3]

    def deq(payload, scales):
        x = _unpack_page(payload[:, pages]).astype(jnp.float32)  # [h, n_pre, ps, d]
        s = scales[pages].transpose(1, 0, 2)                     # [h, n_pre, ps]
        return (x * s[..., None]).reshape(h, n_pre * ps, d)

    return deq(cache.k_p, cache.sk), deq(cache.v_p, cache.sv)


@functools.partial(jax.jit, donate_argnums=(0,))
def append_tokens_paged4(
    cache: Paged4KVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray,
) -> Paged4KVCache:
    """Batched multi-token append: k_new/v_new [n_seqs, h, t, d] at
    positions lengths..lengths+t-1 per row (page-boundary spanning;
    t <= page_size/2 chunks so byte-row scatters never collide). Same
    active / capacity / page-0-overshoot contract as the int8 paged
    append (paged_cache.append_tokens_paged)."""
    ps = cache.page_size
    half = ps // 2
    t = k_new.shape[2]
    k4, sk = _quant4_rows(k_new.astype(jnp.float32))
    v4, sv = _quant4_rows(v_new.astype(jnp.float32))
    max_pages = cache.page_table.shape[1]
    n_pages = cache.n_pages

    def chunk(cache_kp, cache_sk, cache_vp, cache_sv, lengths, c0, c1):
        positions = lengths[:, None] + jnp.arange(c0, c1)[None]  # [s, c]
        page_idx = positions // ps
        offset = positions % ps
        row = offset % half
        nib_hi = (offset // half) == 1
        pages = jnp.take_along_axis(
            cache.page_table, jnp.minimum(page_idx, max_pages - 1), axis=1
        )
        ok = active[:, None] & (page_idx < max_pages)
        pages = jnp.where(ok, pages, n_pages)

        def rmw(buf, vals4):
            # buf [h, n_pages, ps/2, d]; vals4 [s, h, c, d]
            v = jnp.moveaxis(vals4, 0, 1)           # [h, s, c, d]
            cur = buf[:, pages, row]                # [h, s, c, d]
            new = jnp.where(
                nib_hi[None, :, :, None],
                (cur & jnp.int8(0x0F)) | (v << 4),
                (cur & jnp.int8(~0x0F)) | v,
            )
            return buf.at[:, pages, row].set(new, mode="drop")

        def sc(buf, vals):
            # buf [n_pages, h, ps]; vals [s, h, c]
            return buf.at[pages, :, offset].set(
                jnp.moveaxis(vals, 1, 2), mode="drop"
            )

        return (
            rmw(cache_kp, k4[:, :, c0:c1]),
            sc(cache_sk, sk[:, :, c0:c1]),
            rmw(cache_vp, v4[:, :, c0:c1]),
            sc(cache_sv, sv[:, :, c0:c1]),
            jnp.sum(ok, axis=1).astype(jnp.int32),
        )

    kp, skb, vp, svb = cache.k_p, cache.sk, cache.v_p, cache.sv
    adv = jnp.zeros_like(cache.lengths)
    for c0 in range(0, t, half):
        c1 = min(c0 + half, t)
        kp, skb, vp, svb, a = chunk(kp, skb, vp, svb, cache.lengths, c0, c1)
        adv = adv + a
    return cache._replace(k_p=kp, sk=skb, v_p=vp, sv=svb,
                          lengths=cache.lengths + adv)


def paged4_verify_attention(
    q: jnp.ndarray,
    cache: Paged4KVCache,
    sm_scale: float | None = None,
) -> jnp.ndarray:
    """Speculative staircase verify over the int4 paged cache: q [n, H, s, d]
    (kv_cache.verify_decode_attention contract)."""
    n, n_q_heads, s, d = q.shape
    o, _ = _paged4_decode(q.reshape(n, n_q_heads * s, d), cache, sm_scale, s)
    return o.reshape(n, n_q_heads, s, d)


def paged4_decode_attention(
    q: jnp.ndarray,
    cache: Paged4KVCache,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Single-token decode against the int4 paged cache: q [n, H, d]."""
    o, lse = _paged4_decode(q, cache, sm_scale, 1)
    return (o, lse) if return_lse else o


@functools.partial(jax.jit, static_argnames=("sm_scale", "spec"))
def _paged4_decode(q, cache: Paged4KVCache, sm_scale, spec):
    n_kv = cache.k_p.shape[0]
    if q.shape[1] % (n_kv * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {n_kv} kv heads")
    def gather(packed, scales):
        # gather the sequences' packed pages first, then unpack only those
        x = _unpack_page(packed[:, cache.page_table])  # [h, n, mp, ps, d]
        h, n, mp, ps, d = x.shape
        s = jnp.moveaxis(scales[cache.page_table], 2, 1).reshape(n, h, mp * ps)
        return jnp.moveaxis(x, 0, 1).reshape(n, h, mp * ps, d), s

    k, sk = gather(cache.k_p, cache.sk)
    v, sv = gather(cache.v_p, cache.sv)
    return dense_decode(q, k, sk, v, sv, cache.lengths, sm_scale=sm_scale, spec=spec)
