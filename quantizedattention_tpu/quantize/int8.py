"""Symmetric absmax/127 int8 quantization, per-tensor, per-row, and per-block.

Capability parity with the reference's in-kernel quantization
(reference: attention_int8.py:180-195, 232-247 — per-tile absmax/127 symmetric
quantization of Q/K/V and per-q-row quantization of P), re-expressed as pure
jnp functions: an elementwise pass plus a reduction, which XLA fuses into
one pass over the tensor on the GPU.

Divergence from the reference (documented, intentional): the reference casts
float -> int8 with truncation toward zero (torch `.to(torch.int8)`); we use
round-to-nearest-even, which strictly reduces quantization error. See
SURVEY.md §2.3.
"""

from __future__ import annotations

import jax.numpy as jnp

INT8_MAX = 127.0
# Floor for scales so an all-zero tile quantizes to zeros instead of NaN.
_EPS = 1e-12


def absmax_scale(x: jnp.ndarray, axis=None, keepdims: bool = False) -> jnp.ndarray:
    """Symmetric scale s = absmax(x)/127 over `axis` (None = whole tensor)."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=keepdims)
    return jnp.maximum(amax, _EPS) / INT8_MAX


def quantize_int8(x: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """Quantize x by a (broadcastable) scale to int8 with round-to-nearest."""
    scaled = x.astype(jnp.float32) / scale
    return jnp.clip(jnp.round(scaled), -128.0, INT8_MAX).astype(jnp.int8)


def dequantize_int8(x_int8: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    return x_int8.astype(jnp.float32) * scale


def quantize_int8_blocks(x: jnp.ndarray, block_size: int):
    """Per-block quantization along the token axis of a [..., tokens, d] array.

    Mirrors the reference's per-tile Q/K/V quantization where each
    (block_size x d) tile shares one scale (attention_int8.py:180-195).

    Returns (x_int8, scales) with scales shaped [..., tokens // block_size].
    Requires tokens % block_size == 0 (pad upstream).
    """
    *lead, tokens, d = x.shape
    if tokens % block_size != 0:
        raise ValueError(f"tokens={tokens} not divisible by block_size={block_size}")
    nblk = tokens // block_size
    xb = x.reshape(*lead, nblk, block_size, d)
    scales = absmax_scale(xb, axis=(-2, -1))  # [..., nblk]
    x_int8 = quantize_int8(xb, scales[..., None, None]).reshape(*lead, tokens, d)
    return x_int8, scales
