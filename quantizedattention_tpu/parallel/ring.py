"""Ring attention (sequence/context parallelism).

New capability vs the reference (its max tested sequence is 1024 on one GPU,
SURVEY.md §2.4): KV shards rotate around the `context` mesh axis via
jax.lax.ppermute — point-to-point, neighbor-only, so the transfer runs at
the full link rate — while every chip streams its partial online softmax over
the KV block currently in front of it. Partials (O_i, lse_i) are merged with
the exact rescale identity the kernels already use internally
(attention_bf16.py:276-280): the merge is associative, so ring order doesn't
matter.

The ppermute for step s+1 is issued *before* step s's kernel so XLA's
latency-hiding scheduler overlaps transfer with compute.

Causal masking: the kernels take dynamic global q/k offsets, so each ring
step runs ONE kernel with q_offset = my_shard·t and k_offset = src_shard·t —
the in-kernel block-skip prunes fully-masked tiles, and shards entirely in
the future are skipped wholesale with lax.cond.

Differentiability (bf16 path): ring_attention is a custom_vjp whose backward
is itself a ring — (K, V, dK_acc, dV_acc) rotate together; each chip
accumulates its dQ locally and the visiting shard's dK/dV into the rotating
accumulators, which arrive home after one final rotation.

For the int8 path, each chip quantizes its KV shard once and the ring
rotates the int8 payload *and its per-block scale table* — half the link
bytes of a bf16 ring (forward/inference path).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.jvp_bwd import attention_jvp_bwd
from quantizedattention_tpu.ops.jvp_fwd import attention_jvp_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized,
    quantize_qkv,
)
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config

_NEG_INF = float("-inf")


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions via their exp2-domain lse."""
    m = jnp.maximum(lse1, lse2)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    w1 = jnp.where(jnp.isfinite(lse1), jnp.exp2(lse1 - m_safe), 0.0)
    w2 = jnp.where(jnp.isfinite(lse2), jnp.exp2(lse2 - m_safe), 0.0)
    l = w1 + w2
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    lse = jnp.where(l == 0.0, _NEG_INF, m + jnp.log2(l_safe))
    return o, lse


def _rotate(state, axis_name, perm):
    return jax.tree_util.tree_map(lambda x: jax.lax.ppermute(x, axis_name, perm), state)


# --------------------------------------------------------------------------
# bf16 ring: differentiable (custom_vjp; backward is also a ring)
# --------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _ring_bf16(q, k, v, axis_name, causal, sm_scale, config):
    o, _ = _ring_bf16_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o


def _ring_bf16_fwd_impl(q, k, v, axis_name, causal, sm_scale, config):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape
    # GQA: the UNREPEATED kv heads ride the ring (rep x fewer link bytes)
    # AND feed the kernel directly (GQA-native flash_fwd — no local repeat)
    q_off = idx * t_local

    o = jnp.zeros((batch, head, t_local, head_dim), jnp.float32)
    lse = jnp.full((batch, head, t_local), _NEG_INF, jnp.float32)
    kv = (k, v)
    for step in range(n):
        kv_next = _rotate(kv, axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _attend(kv_pair, src=src):
            k_blk, v_blk = kv_pair
            return flash_attention_fwd(
                q, k_blk, v_blk,
                causal=causal, sm_scale=sm_scale, config=config,
                q_offset=q_off, k_offset=src * t_local,
            )

        if causal and step > 0:
            # future shards contribute nothing — skip the kernel wholesale
            o_p, lse_p = jax.lax.cond(
                src < idx,
                _attend,
                lambda kv_pair: (jnp.zeros_like(o), jnp.full_like(lse, _NEG_INF)),
                kv,
            )
        else:
            o_p, lse_p = _attend(kv)
        o, lse = _merge_partials(o, lse, o_p, lse_p)
        if kv_next is not None:
            kv = kv_next
    return o, lse


def _ring_bf16_fwd(q, k, v, axis_name, causal, sm_scale, config):
    o, lse = _ring_bf16_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o, (q, k, v, o, lse)


def _ring_bf16_bwd(axis_name, causal, sm_scale, config, res, do):
    q, k, v, o, lse = res
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    t_local = q.shape[2]
    q_off = idx * t_local

    dq = jnp.zeros_like(q, dtype=jnp.float32)
    # dK/dV accumulators ride the ring WITH their shard: at step s this chip
    # holds shard (idx−s) and the running gradient for exactly that shard
    # (kv-head shaped under GQA: the GQA-native dKV kernel group-sums the
    # repeated-head grads in registers)
    k_blk, v_blk = k, v
    dk_acc = jnp.zeros_like(k, dtype=jnp.float32)
    dv_acc = jnp.zeros_like(v, dtype=jnp.float32)
    for step in range(n):
        # K/V for the next step don't depend on this step's compute — rotate
        # them first so the transfer overlaps the backward kernels
        kv_next = _rotate((k_blk, v_blk), axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _grads(operand, src=src):
            k_b, v_b = operand
            return flash_attention_bwd(
                q, k_b, v_b,
                o, lse, do, causal=causal, sm_scale=sm_scale,
                config=config, q_offset=q_off, k_offset=src * t_local,
                fast=True,  # bf16 dot operands, f32 accumulation (see ops.api)
            )

        if causal and step > 0:
            dq_p, dk_p, dv_p = jax.lax.cond(
                src < idx,
                _grads,
                lambda operand: (
                    jnp.zeros_like(dq), jnp.zeros_like(dk_acc), jnp.zeros_like(dv_acc),
                ),
                (k_blk, v_blk),
            )
        else:
            dq_p, dk_p, dv_p = _grads((k_blk, v_blk))

        dq = dq + dq_p
        dk_acc = dk_acc + dk_p
        dv_acc = dv_acc + dv_p
        if kv_next is not None:
            dk_acc, dv_acc = _rotate((dk_acc, dv_acc), axis_name, perm)
            k_blk, v_blk = kv_next

    # after n-1 rotations the accumulators sit one hop before home
    dk, dv = _rotate((dk_acc, dv_acc), axis_name, perm)
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


_ring_bf16.defvjp(_ring_bf16_fwd, _ring_bf16_bwd)


# --------------------------------------------------------------------------
# int8 ring: quantize local shard once, rotate int8 payload + scales
# (~1/4 the link bytes of a bf16 ring). Differentiable: custom_vjp whose
# backward is itself an int8 ring — the forward's quantized blocks + scales
# rotate again and feed the int8 backward kernels (the residual-reuse
# contract of attention_int8.py:58-65, here stretched across chips).
# --------------------------------------------------------------------------

def _ring_int8_fwd_impl(q, k, v, axis_name, causal, sm_scale, config):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape
    # GQA: quantize + rotate UNREPEATED kv heads; the kernel is GQA-native
    dims = (batch, head, t_local, t_local, head_dim)

    # K-smoothing with the GLOBAL token mean (softmax shift-invariance needs
    # the same shift for every kv position of a row): pmean of equal-size
    # shard means over the ring axis, one [b,h,1,d] collective.
    k_mean = jax.lax.pmean(jnp.mean(k, axis=-2, keepdims=True), axis_name)
    (q_i8, sq), k_res, v_res = quantize_qkv(q, k, v, config, k_sub=k_mean)

    o = jnp.zeros((batch, head, t_local, head_dim), jnp.float32)
    lse = jnp.full((batch, head, t_local), _NEG_INF, jnp.float32)
    kv = (k_res, v_res)
    for step in range(n):
        kv_next = _rotate(kv, axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _attend(kv_state, causal_step):
            # GQA-native kernel: unrepeated int8 payloads + scales go in
            return int8_attention_fwd_from_quantized(
                ((q_i8, sq), kv_state[0], kv_state[1]), dims,
                causal=causal_step, sm_scale=sm_scale, config=config,
            )

        if causal:
            if step == 0:
                o_p, lse_p = _attend(kv, True)  # aligned diagonal shard
            else:
                o_p, lse_p = jax.lax.cond(
                    src < idx,
                    lambda s: _attend(s, False),  # strictly past: attend fully
                    lambda s: (jnp.zeros_like(o), jnp.full_like(lse, _NEG_INF)),
                    kv,
                )
        else:
            o_p, lse_p = _attend(kv, False)
        o, lse = _merge_partials(o, lse, o_p, lse_p)
        if kv_next is not None:
            kv = kv_next
    return o, lse, ((q_i8, sq), k_res, v_res, k_mean)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _ring_int8(q, k, v, axis_name, causal, sm_scale, config):
    o, _, _ = _ring_int8_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o


def _ring_int8_fwd(q, k, v, axis_name, causal, sm_scale, config):
    o, lse, (q_res, k_res, v_res, k_mean) = _ring_int8_fwd_impl(
        q, k, v, axis_name, causal, sm_scale, config
    )
    # zero-size dtype markers (dtypes themselves are not JAX types)
    marks = tuple(jnp.zeros((), x.dtype) for x in (q, k, v))
    return o, (q_res, k_res, v_res, k_mean, o, lse, marks)


def _ring_int8_bwd(axis_name, causal, sm_scale, config, res, do):
    (q_i8, sq), k_res, v_res, k_mean, o, lse, in_dtypes = res
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = o.shape
    h_kv = k_res[0].shape[0] // batch
    # the GQA-native bwd kernel consumes unrepeated residuals and k_mean
    # [b, h_kv, 1, d]; dk/dv come back kv-head shaped (in-kernel group sum)
    dims = (batch, head, t_local, t_local, head_dim)

    dq = jnp.zeros((batch, head, t_local, head_dim), jnp.float32)
    dk_acc = jnp.zeros((batch, h_kv, t_local, head_dim), jnp.float32)
    dv_acc = jnp.zeros_like(dk_acc)
    k_blk, v_blk = k_res, v_res
    for step in range(n):
        kv_next = _rotate((k_blk, v_blk), axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _grads(operand, causal_step):
            return int8_attention_bwd(
                ((q_i8, sq), operand[0], operand[1]), k_mean, o, lse, do,
                dims, causal=causal_step, sm_scale=sm_scale, config=config,
            )

        if causal:
            if step == 0:
                dq_p, dk_p, dv_p = _grads((k_blk, v_blk), True)
            else:
                dq_p, dk_p, dv_p = jax.lax.cond(
                    src < idx,
                    lambda s: _grads(s, False),
                    lambda s: (jnp.zeros_like(dq), jnp.zeros_like(dk_acc),
                               jnp.zeros_like(dv_acc)),
                    (k_blk, v_blk),
                )
        else:
            dq_p, dk_p, dv_p = _grads((k_blk, v_blk), False)

        dq = dq + dq_p
        dk_acc = dk_acc + dk_p
        dv_acc = dv_acc + dv_p
        if kv_next is not None:
            dk_acc, dv_acc = _rotate((dk_acc, dv_acc), axis_name, perm)
            k_blk, v_blk = kv_next

    dk_acc, dv_acc = _rotate((dk_acc, dv_acc), axis_name, perm)
    qm, km, vm = in_dtypes
    return dq.astype(qm.dtype), dk_acc.astype(km.dtype), dv_acc.astype(vm.dtype)


_ring_int8.defvjp(_ring_int8_fwd, _ring_int8_bwd)


def ring_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    axis_name: str,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    kind: str = "bf16",
):
    """Ring attention on per-device shards — call inside shard_map.

    q/k/v: local shards [b, h, t_local, d], sequence sharded identically on
    `axis_name`. Both kinds are differentiable (custom_vjp ring backward);
    kind "int8" quantizes the local shard once (K smoothed with the global
    token mean) and rotates int8 payload + scales in BOTH directions —
    ~1/4 the link bytes of the bf16 ring. Returns the local O shard in f32.
    """
    if config is None:
        config = default_block_config(kind, q.shape[2], q.shape[2], q.shape[3])
    if kind == "bf16":
        return _ring_bf16(q, k, v, axis_name, causal, sm_scale, config)
    if kind == "int8":
        return _ring_int8(q, k, v, axis_name, causal, sm_scale, config)
    raise ValueError(f"unknown ring kind {kind!r}")


def make_ring_attention(
    mesh: Mesh,
    kind: str = "bf16",
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str = "context",
):
    """Jitted ring attention: batch on data, heads on model, sequence on
    context. q/k/v: [batch, head, tokens, head_dim] global arrays."""
    spec = P(data_axis, model_axis, context_axis, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def sharded(q, k, v):
        return ring_attention(
            q, k, v, context_axis, causal=causal, sm_scale=sm_scale,
            config=config, kind=kind,
        )

    return jax.jit(sharded)


# --------------------------------------------------------------------------
# JVP ring: sequence-parallel (O, tO) — long-context rCM distillation.
# The four-way merge is exact: with per-shard normalized partials
# (o_i, to_i, lse_i, mu_i) and weights w_i = exp2(lse_i − m),
#     A_i + B_i = l_i·(to_i + mu_i·o_i)
# so  o  = Σ w_i o_i / Σ w_i,          mu = Σ w_i mu_i / Σ w_i,
#     to = Σ w_i (to_i + mu_i o_i) / Σ w_i − mu·o,
# and lse = m + log2 Σ w_i — no second pass over K/V. The backward is a
# second-order ring: (K, V, tK, tV) rotate with their (dK, dV, dtK, dtV)
# accumulators and each step runs ops/jvp_bwd against the GLOBAL
# (o, to, lse, mu) residuals. No reference counterpart at any scale.
# --------------------------------------------------------------------------

def _merge_jvp_partials(acc, part):
    o1, to1, lse1, mu1 = acc
    o2, to2, lse2, mu2 = part
    m = jnp.maximum(lse1, lse2)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    w1 = jnp.where(jnp.isfinite(lse1), jnp.exp2(lse1 - m_safe), 0.0)
    w2 = jnp.where(jnp.isfinite(lse2), jnp.exp2(lse2 - m_safe), 0.0)
    l = w1 + w2
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    mu = (mu1 * w1 + mu2 * w2) / l_safe
    # numerator of to carries the +mu_i·o_i de-centering per partial
    num = ((to1 + mu1[..., None] * o1) * w1[..., None]
           + (to2 + mu2[..., None] * o2) * w2[..., None]) / l_safe[..., None]
    to = num - mu[..., None] * o
    lse = jnp.where(l == 0.0, _NEG_INF, m + jnp.log2(l_safe))
    return o, to, lse, mu


def _ring_jvp_fwd_impl(q, k, v, tq, tk, tv, axis_name, causal, sm_scale,
                       config, fast):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    batch, head, t_local, head_dim = q.shape

    o = jnp.zeros((batch, head, t_local, head_dim), jnp.float32)
    to = jnp.zeros_like(o)
    lse = jnp.full((batch, head, t_local), _NEG_INF, jnp.float32)
    mu = jnp.zeros_like(lse)
    acc = (o, to, lse, mu)
    kv = (k, v, tk, tv)
    for step in range(n):
        kv_next = _rotate(kv, axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _attend(state, causal_step):
            k_b, v_b, tk_b, tv_b = state
            return attention_jvp_fwd(
                q, k_b, v_b, tq, tk_b, tv_b, causal=causal_step,
                sm_scale=sm_scale, config=config, fast=fast,
            )

        if causal:
            if step == 0:
                part = _attend(kv, True)  # aligned diagonal shard
            else:
                part = jax.lax.cond(
                    src < idx,
                    lambda st: _attend(st, False),
                    lambda st: (jnp.zeros_like(o), jnp.zeros_like(o),
                                jnp.full_like(lse, _NEG_INF), jnp.zeros_like(mu)),
                    kv,
                )
        else:
            part = _attend(kv, False)
        acc = _merge_jvp_partials(acc, part)
        if kv_next is not None:
            kv = kv_next
    return acc


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10))
def _ring_jvp(q, k, v, tq, tk, tv, axis_name, causal, sm_scale, config, fast):
    o, to, _, _ = _ring_jvp_fwd_impl(
        q, k, v, tq, tk, tv, axis_name, causal, sm_scale, config, fast
    )
    return o, to


def _ring_jvp_fwd(q, k, v, tq, tk, tv, axis_name, causal, sm_scale, config, fast):
    o, to, lse, mu = _ring_jvp_fwd_impl(
        q, k, v, tq, tk, tv, axis_name, causal, sm_scale, config, fast
    )
    return (o, to), (q, k, v, tq, tk, tv, o, to, lse, mu)


def _ring_jvp_bwd(axis_name, causal, sm_scale, config, fast, res, cts):
    q, k, v, tq, tk, tv, o, to, lse, mu = res
    do, dto = cts
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]

    dq = jnp.zeros_like(q, dtype=jnp.float32)
    dtq = jnp.zeros_like(dq)
    state = (k, v, tk, tv)
    dk_acc = jnp.zeros_like(k, dtype=jnp.float32)
    dv_acc = jnp.zeros_like(dk_acc)
    dtk_acc = jnp.zeros_like(dk_acc)
    dtv_acc = jnp.zeros_like(dk_acc)
    for step in range(n):
        kv_next = _rotate(state, axis_name, perm) if step < n - 1 else None
        src = (idx - step) % n

        def _grads(st, causal_step):
            k_b, v_b, tk_b, tv_b = st
            return attention_jvp_bwd(
                q, k_b, v_b, tq, tk_b, tv_b, o, to, lse, mu, do, dto,
                causal=causal_step, sm_scale=sm_scale, config=config, fast=fast,
            )

        if causal:
            if step == 0:
                grads = _grads(state, True)
            else:
                grads = jax.lax.cond(
                    src < idx,
                    lambda st: _grads(st, False),
                    lambda st: (jnp.zeros_like(dq), jnp.zeros_like(dk_acc),
                                jnp.zeros_like(dv_acc), jnp.zeros_like(dtq),
                                jnp.zeros_like(dtk_acc), jnp.zeros_like(dtv_acc)),
                    state,
                )
        else:
            grads = _grads(state, False)
        dq_p, dk_p, dv_p, dtq_p, dtk_p, dtv_p = grads
        dq = dq + dq_p
        dtq = dtq + dtq_p
        dk_acc = dk_acc + dk_p
        dv_acc = dv_acc + dv_p
        dtk_acc = dtk_acc + dtk_p
        dtv_acc = dtv_acc + dtv_p
        if kv_next is not None:
            dk_acc, dv_acc, dtk_acc, dtv_acc = _rotate(
                (dk_acc, dv_acc, dtk_acc, dtv_acc), axis_name, perm
            )
            state = kv_next

    dk_acc, dv_acc, dtk_acc, dtv_acc = _rotate(
        (dk_acc, dv_acc, dtk_acc, dtv_acc), axis_name, perm
    )
    return (dq.astype(q.dtype), dk_acc.astype(k.dtype), dv_acc.astype(v.dtype),
            dtq.astype(tq.dtype), dtk_acc.astype(tk.dtype),
            dtv_acc.astype(tv.dtype))


_ring_jvp.defvjp(_ring_jvp_fwd, _ring_jvp_bwd)


def ring_attention_jvp(
    q, k, v, tq, tk, tv,
    axis_name: str,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
):
    """Sequence-parallel (O, tO) pair — call inside shard_map with every
    tensor sequence-sharded on `axis_name`. Differentiable in reverse mode
    (second-order ring backward); the long-context rCM training primitive.
    """
    if config is None:
        config = default_block_config("jvp", q.shape[2], q.shape[2], q.shape[3])
    return _ring_jvp(q, k, v, tq, tk, tv, axis_name, causal, sm_scale, config, fast)
