"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head<->seq swap.

The head-rich alternative to ring attention (SURVEY.md §2.4): inputs arrive
sequence-sharded; one all_to_all per tensor re-shards them head-wise with the
FULL sequence local to each chip, ordinary (aligned-causal) attention runs
locally, and a second all_to_all restores sequence sharding on the output.

Trade-off vs ring: two all-to-alls of activation-sized data instead of N-1
neighbor ppermutes of KV — cheaper when heads >> devices and sequences are
moderate; ring wins at very long context. Fully differentiable: all_to_all
transposes to itself and the local attention is the custom_vjp public API.

Requires n_heads % axis_size == 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quantizedattention_tpu.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu.tune.config import BlockConfig

_KINDS = {"bf16": flash_attention_bf16, "int8": sage_attention_int8}


def ulysses_attention(
    q, k, v,
    axis_name: str,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    kind: str = "bf16",
):
    """Ulysses attention on per-device shards — call inside shard_map.

    q/k/v: local sequence shards [b, h, t_local, d]. Returns the local O
    shard. Differentiable for both kinds.

    GQA: k/v may carry UNREPEATED kv heads (h a multiple of h_kv, both
    divisible by the axis size) — only the kv-group payload rides the
    all-to-alls, and the GQA-native kernels consume the unrepeated heads
    directly (their backwards group-sum dK/dV in registers).
    """
    fn = _KINDS[kind]

    def swap_in(x):  # [b, h, t_loc, d] -> [b, h/n, t, d]
        return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)

    def swap_out(x):  # [b, h/n, t, d] -> [b, h, t_loc, d]
        return jax.lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)

    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    n = jax.lax.axis_size(axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"ulysses all-to-all needs q heads ({q.shape[1]}) AND kv heads "
            f"({k.shape[1]}) divisible by the axis size ({n}); for fewer kv "
            f"heads than chips use ring/zigzag/allgather SP instead"
        )
    q, k, v = swap_in(q), swap_in(k), swap_in(v)
    o = fn(q, k, v, causal=causal, sm_scale=sm_scale, config=config)
    return swap_out(o)


def make_ulysses_attention(
    mesh: Mesh,
    kind: str = "bf16",
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str = "context",
):
    """Jitted Ulysses attention on [batch, head, tokens, head_dim] globals:
    batch on data, heads on model, sequence on context."""
    spec = P(data_axis, model_axis, context_axis, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def sharded(q, k, v):
        return ulysses_attention(
            q, k, v, context_axis, causal=causal, sm_scale=sm_scale,
            config=config, kind=kind,
        )

    return jax.jit(sharded)
