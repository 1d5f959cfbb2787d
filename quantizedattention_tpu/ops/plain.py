"""Plain-JAX attention paths that XLA compiles, processed in q blocks.

These carry the modes where a hand-written Triton kernel does not pay on a
Hopper card: the IEEE-f32 ("exact") forward, backward and JVP forward run
their dots through XLA at Precision.HIGHEST, and the second-order JVP
backward and the tangent-only forward have no kernel at all (PERF.md). The
q axis is processed in blocks (a scan), so the [block, kv] f32 intermediates
stay bounded at long sequence while each block sees the whole kv row.

All functions take [b, h, t, d] q and [b, h_kv, t_kv, d] k/v (h_kv dividing
h: GQA repeats k/v inside); lse is in the exp2 domain (m + log2 l), the
residual contract of the kernels in this package.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.common import MASK_VALUE, pad_tokens, qk_scales


def q_block_size(batch: int, head: int, kv_len: int, q_tokens: int,
                 budget_elems: int = 1 << 26) -> int:
    """Largest power-of-two q block whose [b, h, block, kv] f32 tile stays
    within `budget_elems` (256 MB), at least 16 and at most the padded q."""
    block = 16
    while block * 2 <= q_tokens and batch * head * block * 2 * kv_len <= budget_elems:
        block *= 2
    return block


def einsum(spec, a, b, exact):
    """f32 einsum at IEEE precision, or bf16 operands with f32 accumulation."""
    if exact:
        return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    return jnp.einsum(spec, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def split_q_blocks(x, block: int):
    """[b, h, t, ...] -> [n_blocks, b, h, block, ...] (zero-padded)."""
    x = pad_tokens(x, block, 2)
    b, h, t = x.shape[:3]
    x = x.reshape(b, h, t // block, block, *x.shape[3:])
    return jnp.moveaxis(x, 2, 0)


def merge_q_blocks(x, q_tokens: int):
    """Inverse of split_q_blocks, trimmed to q_tokens."""
    nb, b, h, block = x.shape[:4]
    x = jnp.moveaxis(x, 0, 2).reshape(b, h, nb * block, *x.shape[4:])
    return x[:, :, :q_tokens]


def block_logits(q_blk, k, row0, qk_scale, causal, exact):
    """Masked exp2-domain logits [b, h, block, kv] of a q block whose first
    row sits at global position row0 (keys at 0..kv-1, or shifted by the
    caller's offsets folded into row0)."""
    s = einsum("bhqd,bhkd->bhqk", q_blk * qk_scale, k, exact)
    if causal:
        rows = row0 + jnp.arange(q_blk.shape[2])[:, None]
        cols = jnp.arange(k.shape[2])[None, :]
        s = jnp.where(cols <= rows, s, MASK_VALUE)
    return s


def block_probs(q_blk, k, lse_blk, row0, qk_scale, causal, exact):
    """Normalized P [b, h, block, kv] of a q block given its lse."""
    s = block_logits(q_blk, k, row0, qk_scale, causal, exact)
    return jnp.exp2(s - lse_blk[..., None])


def _expand(x, head):
    return jnp.repeat(x, head // x.shape[1], axis=1)


def _scan_q(fn, q_tokens, block, carry, *q_side):
    """Scan fn(carry, (i, *blocks)) -> (carry, out) over the q blocks."""
    blocks = [split_q_blocks(x, block) for x in q_side]
    n_blocks = blocks[0].shape[0]
    return jax.lax.scan(fn, carry, (jnp.arange(n_blocks), *blocks))


@functools.partial(jax.jit, static_argnames=("causal", "sm_scale"))
def attention_fwd(q, k, v, causal: bool = False, sm_scale: float | None = None,
                  q_offset=0, k_offset=0):
    """IEEE-f32 attention forward. Returns (O f32, lse f32 [b, h, t]).
    q_offset/k_offset: global positions of the local q / kv shards."""
    batch, head, q_tokens, head_dim = q.shape
    _, qk_scale = qk_scales(head_dim, sm_scale)
    f32 = jnp.float32
    k, v = _expand(k.astype(f32), head), _expand(v.astype(f32), head)
    block = q_block_size(batch, head, k.shape[2], q_tokens)
    shift = jnp.asarray(q_offset, jnp.int32) - jnp.asarray(k_offset, jnp.int32)

    def one(_, args):
        i, q_b = args
        s = block_logits(q_b, k, shift + i * block, qk_scale, causal, True)
        m = jnp.max(s, axis=-1)
        p = jnp.exp2(s - m[..., None])
        l = jnp.sum(p, axis=-1)
        o = einsum("bhqk,bhkd->bhqd", p, v, True) / l[..., None]
        return None, (o, m + jnp.log2(l))

    _, (o, lse) = _scan_q(one, q_tokens, block, None, q.astype(f32))
    return merge_q_blocks(o, q_tokens), merge_q_blocks(lse, q_tokens)


@functools.partial(jax.jit, static_argnames=("causal", "sm_scale"))
def attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                  sm_scale: float | None = None, q_offset=0, k_offset=0):
    """IEEE-f32 FlashAttention-2 backward from the forward's (O, lse):
    dS = P ∘ (dP − D), D = rowsum(dO ∘ O). Returns (dq, dk, dv) f32, dk/dv
    on the kv-head count (GQA group sums)."""
    batch, head, q_tokens, head_dim = q.shape
    kv_head = k.shape[1]
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    f32 = jnp.float32
    k, v = _expand(k.astype(f32), head), _expand(v.astype(f32), head)
    block = q_block_size(batch, head, k.shape[2], q_tokens)
    shift = jnp.asarray(q_offset, jnp.int32) - jnp.asarray(k_offset, jnp.int32)
    di = jnp.sum(do.astype(f32) * o.astype(f32), axis=-1)

    def step(acc, args):
        i, q_b, do_b, lse_b, di_b = args
        p = block_probs(q_b, k, lse_b, shift + i * block, qk_scale, causal, True)
        dp = einsum("bhqd,bhkd->bhqk", do_b, v, True)
        ds = p * (dp - di_b[..., None]) * sm_scale
        dk, dv = acc
        dk = dk + einsum("bhqk,bhqd->bhkd", ds, q_b, True)
        dv = dv + einsum("bhqk,bhqd->bhkd", p, do_b, True)
        return (dk, dv), einsum("bhqk,bhkd->bhqd", ds, k, True)

    zeros = jnp.zeros_like(k)
    (dk, dv), dq = _scan_q(step, q_tokens, block, (zeros, zeros), q.astype(f32),
                           do.astype(f32), lse.astype(f32), di)

    def group_sum(x):
        return x.reshape(batch, kv_head, head // kv_head, *x.shape[2:]).sum(axis=2)

    return merge_q_blocks(dq, q_tokens), group_sum(dk), group_sum(dv)


@functools.partial(jax.jit, static_argnames=("causal", "sm_scale"))
def attention_jvp_fwd(q, k, v, tq, tk, tv, causal: bool = False,
                      sm_scale: float | None = None):
    """IEEE-f32 (O, tO, lse, mu) — the math of ops/jvp_fwd:
    tS = (tQ Kᵀ + Q tKᵀ)·sm_scale, tO = (P tV + (P∘tS) V − r·O) / l,
    mu = r / l."""
    batch, head, q_tokens, head_dim = q.shape
    sm_scale, qk_scale = qk_scales(head_dim, sm_scale)
    f32 = jnp.float32
    k, v, tk, tv = (x.astype(f32) for x in (k, v, tk, tv))
    block = q_block_size(batch, head, k.shape[2], q_tokens)

    def one(_, args):
        i, q_b, tq_b = args
        s = block_logits(q_b, k, i * block, qk_scale, causal, True)
        m = jnp.max(s, axis=-1)
        p = jnp.exp2(s - m[..., None])
        l = jnp.sum(p, axis=-1)
        ts = (einsum("bhqd,bhkd->bhqk", tq_b, k, True)
              + einsum("bhqd,bhkd->bhqk", q_b, tk, True)) * sm_scale
        h = p * ts
        r = jnp.sum(h, axis=-1)
        o = einsum("bhqk,bhkd->bhqd", p, v, True) / l[..., None]
        to = (einsum("bhqk,bhkd->bhqd", p, tv, True) + einsum("bhqk,bhkd->bhqd", h, v, True)
              - r[..., None] * o) / l[..., None]
        return None, (o, to, m + jnp.log2(l), r / l)

    _, outs = _scan_q(one, q_tokens, block, None, q.astype(f32), tq.astype(f32))
    return tuple(merge_q_blocks(x, q_tokens) for x in outs)
