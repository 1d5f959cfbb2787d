"""Paged int8 KV cache + plain-JAX paged decode attention.

Beyond-reference serving capability (the reference has no serving layer at
all, SURVEY.md §1; the slot cache in kv_cache.py reserves max_seq tokens per
slot — paging removes that): K/V live in a global pool of fixed-size pages
and every sequence owns a list of pages via a page table, so device memory holds
exactly ceil(len/page_size) pages per live sequence. Page allocation is
host-side policy (the native C++ allocator in serve/scheduler.py /
native/scheduler.cpp, with a Python twin).

Decode gathers each sequence's pages by its page table and runs
kv_cache.dense_decode (plain jnp, XLA-compiled) on the gathered payloads;
a Triton paged kernel (template: jax's pallas/ops/gpu/paged_attention.py)
is listed in ROADMAP.md.

Layouts:
  k_pages / v_pages : [n_kv_heads, n_pages, page_size, head_dim] int8
  sk / sv           : [n_pages, n_kv_heads, page_size] f32
  page_table        : [n_seqs, max_pages_per_seq] int32 (unused slots: 0)
  lengths           : [n_seqs] int32 (tokens live per sequence)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quantizedattention_tpu.parallel.kv_cache import _row_quant, dense_decode

_PAGE_TILE = 128
DEFAULT_PAGE_SIZE = 128


class PagedKVCache(NamedTuple):
    k_pages: jnp.ndarray   # [h_kv, n_pages, page_size, d] int8
    sk: jnp.ndarray        # [n_pages, h_kv, page_size] f32
    v_pages: jnp.ndarray   # [h_kv, n_pages, page_size, d] int8
    sv: jnp.ndarray        # [n_pages, h_kv, page_size] f32
    page_table: jnp.ndarray  # [n_seqs, max_pages] int32
    lengths: jnp.ndarray   # [n_seqs] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]


def init_paged_cache(
    n_kv_heads: int,
    n_pages: int,
    n_seqs: int,
    max_pages_per_seq: int,
    head_dim: int,
    page_size: int = DEFAULT_PAGE_SIZE,
) -> PagedKVCache:
    if page_size % _PAGE_TILE != 0:
        raise ValueError(f"page_size={page_size} must be a multiple of {_PAGE_TILE}")
    return PagedKVCache(
        k_pages=jnp.zeros((n_kv_heads, n_pages, page_size, head_dim), jnp.int8),
        sk=jnp.zeros((n_pages, n_kv_heads, page_size), jnp.float32),
        v_pages=jnp.zeros((n_kv_heads, n_pages, page_size, head_dim), jnp.int8),
        sv=jnp.zeros((n_pages, n_kv_heads, page_size), jnp.float32),
        page_table=jnp.zeros((n_seqs, max_pages_per_seq), jnp.int32),
        lengths=jnp.zeros((n_seqs,), jnp.int32),
    )




@jax.jit
def assign_pages(cache: PagedKVCache, seq: jnp.ndarray, pages: jnp.ndarray) -> PagedKVCache:
    """Install a host-allocated page list for `seq` (unused tail must be 0)
    and reset its length. Page ids come from the (native) allocator."""
    return cache._replace(
        page_table=cache.page_table.at[seq].set(pages.astype(jnp.int32)),
        lengths=cache.lengths.at[seq].set(0),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def write_prompt_paged(
    cache: PagedKVCache,
    seq: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    true_len: jnp.ndarray,
) -> PagedKVCache:
    """Prefill: quantize [h, t_pad, d] K/V (t_pad a multiple of page_size)
    and scatter them into the pages `seq` owns; set length = true_len."""
    h, t_pad, d = k_new.shape
    ps = cache.page_size
    n_prompt_pages = t_pad // ps
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))
    pages = jax.lax.dynamic_slice(
        cache.page_table[seq], (0,), (min(n_prompt_pages, cache.page_table.shape[1]),)
    )

    k_i8 = k_i8.reshape(h, n_prompt_pages, ps, d)
    v_i8 = v_i8.reshape(h, n_prompt_pages, ps, d)
    sk = sk.reshape(h, n_prompt_pages, ps).swapaxes(0, 1)  # [np, h, ps]
    sv = sv.reshape(h, n_prompt_pages, ps).swapaxes(0, 1)
    return cache._replace(
        k_pages=cache.k_pages.at[:, pages].set(k_i8),
        sk=cache.sk.at[pages].set(sk),
        v_pages=cache.v_pages.at[:, pages].set(v_i8),
        sv=cache.sv.at[pages].set(sv),
        lengths=cache.lengths.at[seq].set(true_len.astype(jnp.int32)),
    )


def write_chunk_paged(
    cache: PagedKVCache,
    seq: jnp.ndarray,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    page_start: int,
    new_len: jnp.ndarray,
) -> PagedKVCache:
    """Chunked prefill: quantize [h, c, d] K/V (c a multiple of page_size)
    into the pages `seq` owns starting at table column `page_start` (static
    — the engine's chunk grid is page-aligned); set length = new_len.
    The caller trims c so page_start + c/ps <= max_pages (an untrimmed
    dynamic_slice would clamp and corrupt earlier pages)."""
    h, c, d = k_new.shape
    ps = cache.page_size
    n_chunk_pages = c // ps
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))
    pages = jax.lax.dynamic_slice(
        cache.page_table[seq], (page_start,), (n_chunk_pages,)
    )
    k_i8 = k_i8.reshape(h, n_chunk_pages, ps, d)
    v_i8 = v_i8.reshape(h, n_chunk_pages, ps, d)
    sk = sk.reshape(h, n_chunk_pages, ps).swapaxes(0, 1)
    sv = sv.reshape(h, n_chunk_pages, ps).swapaxes(0, 1)
    return cache._replace(
        k_pages=cache.k_pages.at[:, pages].set(k_i8),
        sk=cache.sk.at[pages].set(sk),
        v_pages=cache.v_pages.at[:, pages].set(v_i8),
        sv=cache.sv.at[pages].set(sv),
        lengths=cache.lengths.at[seq].set(new_len.astype(jnp.int32)),
    )


def read_prefix_paged(cache: PagedKVCache, seq: jnp.ndarray, n_tokens: int):
    """Gather + dequantize the first `n_tokens` (static, a multiple of
    page_size) of sequence `seq` from its pages: returns (k, v) f32
    [h, n_tokens, d] — the chunked-prefill prefix, read back exactly as
    every later decode step will see it."""
    ps = cache.page_size
    n_pre = n_tokens // ps
    pages = cache.page_table[seq][:n_pre]
    h = cache.k_pages.shape[0]
    d = cache.k_pages.shape[3]

    def deq(payload, scales):
        x = payload[:, pages].astype(jnp.float32)      # [h, n_pre, ps, d]
        s = scales[pages].transpose(1, 0, 2)           # [h, n_pre, ps]
        return (x * s[..., None]).reshape(h, n_pre * ps, d)

    return deq(cache.k_pages, cache.sk), deq(cache.v_pages, cache.sv)


@functools.partial(jax.jit, donate_argnums=(0,))
def append_token_paged(
    cache: PagedKVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray,
) -> PagedKVCache:
    """Batched single-token append: k_new/v_new [n_seqs, h, 1, d]; rows with
    active=False neither write nor advance. The page for position `len` must
    already be assigned (host allocator extends tables ahead of the write)."""
    return append_tokens_paged(cache, k_new, v_new, active)


@functools.partial(jax.jit, donate_argnums=(0,))
def append_tokens_paged(
    cache: PagedKVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray,
) -> PagedKVCache:
    """Batched multi-token append (the speculative-verify path): k_new/v_new
    [n_seqs, h, t, d] land at positions lengths..lengths+t-1 per row —
    token runs may span a page boundary (per-token page/offset lookup).
    Rows with active=False neither write nor advance.

    Positions whose page-table slot is unassigned (id 0) scatter onto the
    reserved garbage page 0 — by design: a verify step may transiently
    write up to t-1 tokens past a row's allocated budget; every q row that
    could READ those positions is itself beyond the budget, so its emitted
    token is discarded host-side (see ServingEngine spec_decode + paged).
    """
    ps = cache.page_size
    t = k_new.shape[2]
    k_i8, sk = _row_quant(k_new.astype(jnp.float32))  # [s, h, t, d] / [s, h, t]
    v_i8, sv = _row_quant(v_new.astype(jnp.float32))

    positions = cache.lengths[:, None] + jnp.arange(t)[None]  # [s, t]
    page_idx = positions // ps
    offset = positions % ps
    max_pages = cache.page_table.shape[1]
    pages = jnp.take_along_axis(
        cache.page_table, jnp.minimum(page_idx, max_pages - 1), axis=1
    )  # [s, t]
    # rows that must not write: inactive (stale table may point at a page
    # since re-allocated to a live sequence) or at full table capacity
    # (take_along_axis would otherwise clip onto the LAST page and corrupt
    # it). Route both out of range and drop the scatter; neither advances.
    ok = active[:, None] & (page_idx < max_pages)  # [s, t]
    n_pages = cache.n_pages
    pages = jnp.where(ok, pages, n_pages)

    def scatter_kv(buf, val):
        # buf [h, n_pages, ps, d]; val [s, h, t, d]
        v = jnp.moveaxis(val, 0, 1)  # [h, s, t, d]
        return buf.at[:, pages, offset].set(v, mode="drop")

    def scatter_scale(buf, val):
        # buf [n_pages, h, ps]; val [s, h, t] -> advanced idx puts [s, t] first
        return buf.at[pages, :, offset].set(jnp.moveaxis(val, 1, 2), mode="drop")

    adv = jnp.sum(ok, axis=1).astype(jnp.int32)  # only written tokens advance
    return cache._replace(
        k_pages=scatter_kv(cache.k_pages, k_i8),
        sk=scatter_scale(cache.sk, sk),
        v_pages=scatter_kv(cache.v_pages, v_i8),
        sv=scatter_scale(cache.sv, sv),
        lengths=cache.lengths + adv,
    )


def gather_pages(pages: jnp.ndarray, scales: jnp.ndarray, table: jnp.ndarray):
    """Payload [h, n_pages, ps, d] and scales [n_pages, h, ps] gathered by a
    page table [n, max_pages] into per-sequence [n, h, max_pages·ps, d] /
    [n, h, max_pages·ps] (unassigned slots read the reserved page 0 and
    are masked by length)."""
    h, _, ps, d = pages.shape
    n, mp = table.shape
    x = jnp.moveaxis(pages[:, table], 0, 1).reshape(n, h, mp * ps, d)
    s = jnp.moveaxis(scales[table], 2, 1).reshape(n, h, mp * ps)
    return x, s


def paged_verify_attention(
    q: jnp.ndarray,
    cache: PagedKVCache,
    sm_scale: float | None = None,
) -> jnp.ndarray:
    """Speculative staircase verify over the paged cache: q [n, H, s, d]
    (same contract as kv_cache.verify_decode_attention — the s tokens'
    K/V must already be appended, row j attends cols <= lengths-s+j).
    Returns [n, H, s, d] f32."""
    n, n_q_heads, s, d = q.shape
    o, _ = _paged_decode(q.reshape(n, n_q_heads * s, d), cache, sm_scale, s)
    return o.reshape(n, n_q_heads, s, d)


def paged_decode_attention(
    q: jnp.ndarray,
    cache: PagedKVCache,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Single-token decode against the paged cache: q [n_seqs, n_q_heads, d]
    (GQA supported). Returns o [n, H, d] f32 (and lse with return_lse)."""
    o, lse = _paged_decode(q, cache, sm_scale, 1)
    return (o, lse) if return_lse else o


@functools.partial(jax.jit, static_argnames=("sm_scale", "spec"))
def _paged_decode(q, cache: PagedKVCache, sm_scale, spec):
    n_kv = cache.k_pages.shape[0]
    if q.shape[1] % (n_kv * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {n_kv} kv heads")
    k, sk = gather_pages(cache.k_pages, cache.sk, cache.page_table)
    v, sv = gather_pages(cache.v_pages, cache.sv, cache.page_table)
    return dense_decode(q, k, sk, v, sv, cache.lengths, sm_scale=sm_scale, spec=spec)
