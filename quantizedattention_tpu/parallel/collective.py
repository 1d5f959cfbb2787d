"""All-gather / reduce-scatter attention variants (sequence parallelism).

The north-star (BASELINE.json) names the classic XLA-collective layout
explicitly: "all-gather of K/V shards, reduce-scatter of O". Ring attention
(parallel/ring.py) hides the same traffic inside ppermute hops; these
variants spend it up front, which wins when per-hop latency dominates (short
sequences, small shards) or when XLA can overlap one big all-gather with the
first kv tiles better than n-1 dependent hops:

  * allgather_kv_attention — Q stays sequence-sharded, K/V shards all-gather
    to full length before ONE kernel launch per chip. Differentiable: the
    backward computes full-length dK/dV from the local Q shard and
    reduce-scatters them back to their owners (psum_scatter — the mirror
    collective of the forward's all_gather), while dQ needs no communication.
  * kv_sharded_attention — Q replicated, K/V sharded; each chip computes a
    normalized partial over its KV slice and the partials merge with the
    (m, l) rescale identity via three psum-family collectives. Forward /
    serving path (the training-side equivalent is the ring).

Both run inside shard_map on the `context` mesh axis and reuse the offset
support the kernels already have for causal masking across shards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized,
    quantize_qkv,
)
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config


def lse_weighted_merge(o, lse, axis_name):
    """Merge normalized attention partials across `axis_name`:
    m = pmax(lse); w = exp2(lse − m); O = psum(w·O) / psum(w).
    lse is exp2-domain, -inf on rows with no live keys (weight 0). Shared by
    kv_sharded_attention and context_sharded_decode (kv_cache.py)."""
    m = jax.lax.pmax(lse, axis_name)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.where(jnp.isfinite(lse), jnp.exp2(lse - m_safe), 0.0)
    num = jax.lax.psum(o * w[..., None], axis_name)
    den = jax.lax.psum(w, axis_name)
    den = jnp.where(den == 0.0, 1.0, den)
    return num / den[..., None]


# ---------------------------------------------------------------------------
# all-gather K/V, reduce-scatter dK/dV (differentiable)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def allgather_kv_attention(q, k, v, axis_name, causal=False, sm_scale=None,
                           config: BlockConfig | None = None):
    """Sequence-parallel attention: all-gather the KV shards, one kernel.

    q/k/v: local shards [b, h, t_local, d], sequence sharded identically on
    `axis_name` (call inside shard_map). Returns the local O shard (f32).
    """
    o, _ = _ag_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o


def _ag_fwd_impl(q, k, v, axis_name, causal, sm_scale, config):
    idx = jax.lax.axis_index(axis_name)
    t_local = q.shape[2]
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    # GQA: gather the UNREPEATED kv-group payload (1/rep the link bytes);
    # the GQA-native kernel consumes it directly — no repeated copy exists
    # anywhere (fwd, residuals, or bwd)
    k_full = jax.lax.all_gather(k, axis_name, axis=2, tiled=True)
    v_full = jax.lax.all_gather(v, axis_name, axis=2, tiled=True)
    if config is None:
        config = default_block_config("bf16", t_local, k_full.shape[2])
    o, lse = flash_attention_fwd(
        q, k_full, v_full, causal=causal, sm_scale=sm_scale, config=config,
        q_offset=idx * t_local, k_offset=0,
    )
    return o, (q, k_full, v_full, o, lse)


def _ag_fwd(q, k, v, axis_name, causal, sm_scale, config):
    o, res = _ag_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o, res


def _ag_bwd(axis_name, causal, sm_scale, config, res, do):
    q, k_full, v_full, o, lse = res
    if config is None:
        config = default_block_config("bf16", q.shape[2], k_full.shape[2])
    idx = jax.lax.axis_index(axis_name)
    t_local = q.shape[2]
    # GQA-native backward: dk/dv come back kv-head shaped (in-kernel sum)
    dq, dk_full, dv_full = flash_attention_bwd(
        q, k_full, v_full, o, lse, do, causal=causal, sm_scale=sm_scale,
        config=config, q_offset=idx * t_local, k_offset=0, fast=True,
    )
    # each chip holds dK/dV contributions from ITS q shard over the FULL kv
    # length; the true shard gradient is the sum over chips, delivered back
    # to the shard's owner — exactly one reduce-scatter per tensor.
    dk = jax.lax.psum_scatter(dk_full, axis_name, scatter_dimension=2, tiled=True)
    dv = jax.lax.psum_scatter(dv_full, axis_name, scatter_dimension=2, tiled=True)
    return dq.astype(q.dtype), dk.astype(k_full.dtype), dv.astype(v_full.dtype)


allgather_kv_attention.defvjp(_ag_fwd, _ag_bwd)


# ---------------------------------------------------------------------------
# int8 all-gather: gather QUANTIZED payload + scales — 1/4 the link bytes
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def allgather_kv_attention_int8(q, k, v, axis_name, causal=False, sm_scale=None,
                                config: BlockConfig | None = None):
    """Sequence-parallel int8 attention: each chip quantizes its KV shard
    (K smoothed with the global token mean), the int8 payload + per-block
    scales all-gather (~1/4 the bytes of a bf16 gather), one int8 kernel
    per chip. Differentiable: the backward recomputes from the gathered
    residuals and reduce-scatters dK/dV home (GQA: the unrepeated kv-group
    payload + scales ride the wire AND feed the GQA-native kernel directly;
    dK/dV come back kv-head shaped). Causal masking
    uses the int8 kernels' global q/k offsets. t_local must be a multiple
    of 128 so the gathered quantization grid has no interior padding.
    """
    o, _ = _ag_i8_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o


def _ag_i8_fwd_impl(q, k, v, axis_name, causal, sm_scale, config):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    batch, head, t_local, head_dim = q.shape
    if head % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    # GQA: gather the UNREPEATED quantized payload; the kernel is GQA-native
    if t_local % 128 != 0:
        raise ValueError("int8 all-gather requires t_local % 128 == 0")
    if config is None:
        config = default_block_config("int8", t_local, t_local, head_dim)
    # clamp blocks to the SHARD length: per-shard quantization padding would
    # otherwise become unmasked INTERIOR padding after the gather (the
    # kernel's padding mask is tail-only) — with the clamp, padded == t_local
    # and the concatenation is gap-free.
    config = config.clamp(t_local, t_local)
    if t_local % config.block_kv != 0:
        raise ValueError(
            f"int8 all-gather: t_local={t_local} must be a multiple of the "
            f"kv quantization tile ({config.block_kv})"
        )
    k_mean = jax.lax.pmean(jnp.mean(k, axis=-2, keepdims=True), axis_name)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = quantize_qkv(q, k, v, config, k_sub=k_mean)
    # gather along the (padded == t_local) token axis; scale tables gather
    # along their block axis — every shard shares the same grain, so the
    # concatenation IS the global quantization grid
    k_i8f = jax.lax.all_gather(k_i8, axis_name, axis=1, tiled=True)
    sk_f = jax.lax.all_gather(sk, axis_name, axis=1, tiled=True)
    v_i8f = jax.lax.all_gather(v_i8, axis_name, axis=1, tiled=True)
    sv_f = jax.lax.all_gather(sv, axis_name, axis=1, tiled=True)
    dims = (batch, head, t_local, n * t_local, head_dim)
    # residuals keep the UNREPEATED gathered payload; the GQA-native kernel
    # consumes it directly (fwd here, bwd in _ag_i8_bwd)
    residuals = ((q_i8, sq), (k_i8f, sk_f), (v_i8f, sv_f))
    q_off = idx * t_local
    o, lse = int8_attention_fwd_from_quantized(
        residuals, dims, causal=causal, sm_scale=sm_scale, config=config,
        q_offset=q_off, k_offset=0,
    )
    return o, (residuals, k_mean, o, lse, dims, q_off,
               tuple(jnp.zeros((), x.dtype) for x in (q, k, v)))


def _ag_i8_fwd(q, k, v, axis_name, causal, sm_scale, config):
    o, res = _ag_i8_fwd_impl(q, k, v, axis_name, causal, sm_scale, config)
    return o, res


def _ag_i8_bwd(axis_name, causal, sm_scale, config, res, do):
    (q_res, k_res, v_res), k_mean, o, lse, dims, q_off, marks = res
    # GQA-native backward: unrepeated residuals in, kv-head grads out
    dq, dk_full, dv_full = int8_attention_bwd(
        (q_res, k_res, v_res), k_mean, o, lse, do, dims,
        causal=causal, sm_scale=sm_scale, config=config,
        q_offset=q_off, k_offset=0,
    )
    dk = jax.lax.psum_scatter(dk_full, axis_name, scatter_dimension=2, tiled=True)
    dv = jax.lax.psum_scatter(dv_full, axis_name, scatter_dimension=2, tiled=True)
    qm, km, vm = marks
    return dq.astype(qm.dtype), dk.astype(km.dtype), dv.astype(vm.dtype)


allgather_kv_attention_int8.defvjp(_ag_i8_fwd, _ag_i8_bwd)


# ---------------------------------------------------------------------------
# KV-sharded partials, lse-weighted merge (forward / serving)
# ---------------------------------------------------------------------------

def kv_sharded_attention(q, k, v, axis_name, causal=False, sm_scale=None,
                         config: BlockConfig | None = None):
    """Attention with replicated Q and sequence-sharded K/V — call inside
    shard_map. Each chip streams its KV slice; partials merge via
    m = pmax(lse), w = exp2(lse − m), O = psum(w·O̅) / psum(w).
    """
    idx = jax.lax.axis_index(axis_name)
    t_local = k.shape[2]
    if config is None:
        config = default_block_config("bf16", q.shape[2], t_local)
    o, lse = flash_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config,
        q_offset=0, k_offset=idx * t_local,
    )
    return lse_weighted_merge(o, lse, axis_name)


def kv_sharded_attention_int8(q, k, v, axis_name, causal=False, sm_scale=None,
                              config: BlockConfig | None = None):
    """int8 variant of kv_sharded_attention: replicated Q, sequence-sharded
    K/V quantized per shard (K smoothed with the global token mean); each
    chip runs the int8 kernel over its slice with a global k_offset, and
    the normalized partials merge with the lse rescale identity. Forward /
    serving path (the training-side int8 SP is the ring or int8 all-gather).
    """
    idx = jax.lax.axis_index(axis_name)
    t_local = k.shape[2]
    batch, head = q.shape[0], q.shape[1]
    head_dim = q.shape[3]
    if config is None:
        config = default_block_config("int8", q.shape[2], t_local, head_dim)
    config = config.clamp(q.shape[2], t_local)
    k_mean = jax.lax.pmean(jnp.mean(k, axis=-2, keepdims=True), axis_name)
    residuals = quantize_qkv(q, k, v, config, k_sub=k_mean)
    dims = (batch, head, q.shape[2], t_local, head_dim)
    o, lse = int8_attention_fwd_from_quantized(
        residuals, dims, causal=causal, sm_scale=sm_scale, config=config,
        q_offset=0, k_offset=idx * t_local,
    )
    return lse_weighted_merge(o, lse, axis_name)


def make_allgather_attention(
    mesh: Mesh,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str = "context",
    kind: str = "bf16",
):
    """Jitted all-gather-KV attention on global [b, h, t, d] arrays: batch on
    data, heads on model, sequence on context (same layout as
    make_ring_attention — swap one for the other freely)."""
    spec = P(data_axis, model_axis, context_axis, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def sharded(q, k, v):
        if kind == "int8":
            return allgather_kv_attention_int8(
                q, k, v, context_axis, causal=causal, sm_scale=sm_scale,
                config=config,
            )
        return allgather_kv_attention(
            q, k, v, context_axis, causal=causal, sm_scale=sm_scale, config=config
        )

    return jax.jit(sharded)
