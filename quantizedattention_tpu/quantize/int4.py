"""Split-half int4 nibble packing, shared by the int4 weight format
(quantize/weights.py) and the int4 KV caches (parallel/kv4_cache.py,
parallel/paged4_cache.py).

For a [K, n] int4-valued array, byte [r, c] of the packed [K/2, n] int8
array holds row r of the LOWER half in its low nibble and row r + K/2 of the
UPPER half in its high nibble: unpacking is two shifts per byte, and a
token's (or weight row's) nibble position depends only on its own index.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_int4(w4: jnp.ndarray) -> jnp.ndarray:
    """[K, n] int4-valued int8 (each in [-8, 7]) -> [K/2, n] packed bytes.

    Split-half: byte r = (w4[r] & 0xF) | (w4[r + K/2] << 4). K must be even.
    """
    k = w4.shape[0]
    if k % 2 != 0:
        raise ValueError(f"pack_int4 wants an even K, got {k}")
    lo = w4[: k // 2].astype(jnp.int32) & 0xF
    hi = w4[k // 2 :].astype(jnp.int32) & 0xF
    return (lo | (hi << 4)).astype(jnp.int8)


def unpack_int4(packed: jnp.ndarray):
    """[K/2, n] packed bytes -> (lo, hi) int32 halves, sign-extended."""
    p = packed.astype(jnp.int32)
    lo = (p << 28) >> 28  # bits 0-3, sign-extended
    hi = (p << 24) >> 28  # bits 4-7, sign-extended
    return lo, hi
