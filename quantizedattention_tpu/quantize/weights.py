"""Weight-only int8 quantization for serving: per-channel scales + a
drop-in matmul that dispatches plain arrays unchanged.

No reference counterpart (the reference quantizes attention operands only,
attention_int8.py:97-263); this extends the same symmetric absmax/127
scheme (quantize/int8.py) to the model's linear weights so decode — which
is bound by weight bytes at serving batch sizes — stores half the bytes.
The matmul is plain XLA: the int8 (or unpacked int4) weight is converted
and scaled in the dot's operand path, which XLA fuses into the GEMM's load.

Granularity: one f32 scale per OUTPUT channel (the contraction axis is
reduced, so a per-output-column scale factors exactly out of the dot —
the quantization error is per-element rounding only, <= 0.5/127 relative
to each column's absmax). The embedding table quantizes per ROW (gathers
dequantize the few touched rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from quantizedattention_tpu.quantize.int4 import pack_int4, unpack_int4
from quantizedattention_tpu.quantize.int8 import _EPS, absmax_scale, quantize_int8


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedWeight:
    """An int8 tensor + f32 per-channel scale along `axis` (static).

    For a [k, n] linear weight, axis=1 (per output column); for a
    [vocab, d] embedding, axis=0 (per row, dequantized on gather).
    """

    w_i8: jnp.ndarray
    scale: jnp.ndarray
    axis: int = 1

    def tree_flatten(self):
        return (self.w_i8, self.scale), (self.axis,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], leaves[1], *aux)

    @property
    def shape(self):
        return self.w_i8.shape

    @property
    def dtype(self):  # for param-size accounting / dtype-casting maps
        return self.w_i8.dtype

    def dequantize(self, dtype=jnp.float32) -> jnp.ndarray:
        shape = [1] * self.w_i8.ndim
        shape[self.axis] = -1
        return (
            self.w_i8.astype(jnp.float32) * self.scale.reshape(shape)
        ).astype(dtype)


def quantize_weight(w: jnp.ndarray, axis: int = 1) -> QuantizedWeight:
    """Symmetric absmax/127 int8 per-channel along `axis` (kept axis)."""
    reduce_axes = tuple(a for a in range(w.ndim) if a != axis)
    scale = absmax_scale(w, axis=reduce_axes, keepdims=True)
    w_i8 = quantize_int8(w, scale)
    return QuantizedWeight(w_i8, scale.reshape(-1).astype(jnp.float32), axis)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedWeight4:
    """A [k, n] weight as split-half packed int4 nibbles + group scales.

    `packed` [Kp/2, n] int8 (two nibbles per byte, quantize/int4.py
    layout), `scale` [Kp/group, n] f32 where Kp is k padded to a multiple
    of 2*group (zero rows, so padding contributes nothing to any dot).
    One quarter of bf16's weight HBM bytes on the decode path.
    """

    packed: jnp.ndarray
    scale: jnp.ndarray
    k: int
    group: int = 128

    def tree_flatten(self):
        return (self.packed, self.scale), (self.k, self.group)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], leaves[1], *aux)

    @property
    def shape(self):
        return (self.k, self.packed.shape[1])

    @property
    def dtype(self):
        return self.packed.dtype

    def dequantize(self, dtype=jnp.float32) -> jnp.ndarray:
        lo, hi = unpack_int4(self.packed)
        w4 = jnp.concatenate([lo, hi], axis=0).astype(jnp.float32)
        kp, n = w4.shape
        wg = w4.reshape(kp // self.group, self.group, n) * self.scale[:, None, :]
        return wg.reshape(kp, n)[: self.k].astype(dtype)


def quantize_weight_int4(w: jnp.ndarray, group: int = 128) -> QuantizedWeight4:
    """Symmetric absmax/7 int4 with one scale per (`group` k-rows, column)."""
    if w.ndim != 2:
        raise ValueError("quantize_weight_int4 wants a [k, n] matrix")
    k, n = w.shape
    kp = -(-k // (2 * group)) * (2 * group)
    wp = jnp.pad(w.astype(jnp.float32), ((0, kp - k), (0, 0)))
    wg = wp.reshape(kp // group, group, n)
    scale = jnp.maximum(jnp.max(jnp.abs(wg), axis=1), _EPS) / 7.0  # [Kp/g, n]
    w4 = jnp.clip(jnp.round(wg / scale[:, None, :]), -8, 7)
    w4 = w4.reshape(kp, n).astype(jnp.int8)
    return QuantizedWeight4(pack_int4(w4), scale.astype(jnp.float32), k, group)


# transformer LM linear weights ([in, out] — scale per output column) and
# the embedding table ([vocab, d] — scale per row)
_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def quantize_lm_weights(
    params: dict, include_embed: bool = True, bits: int = 8, group: int = 128,
) -> dict:
    """Quantize a models.transformer param tree's matmul weights to int8
    (bits=8, per-output-channel scales) or int4 (bits=4, `group`-row group
    scales — one quarter of bf16's weight bytes).

    Norm gains stay float (tiny, numerically sensitive); the embedding
    table stays per-row int8 even at bits=4 (it is read by GATHER, a few
    rows per step — not part of the weight-bandwidth bottleneck the int4
    path exists for, and per-row int8 is more accurate). Returns a new
    tree with QuantizedWeight/QuantizedWeight4 leaves; every decode/prefill
    path accepts it because all matmuls route through `mm` and gathers
    through `embedding_lookup`.
    """
    if bits == 8:
        def quant(w):
            return quantize_weight(w, axis=1)
    elif bits == 4:
        def quant(w):
            return quantize_weight_int4(w, group=group)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = dict(params)
    out["layers"] = [
        {
            key: quant(leaf) if key in _LINEAR_KEYS else leaf
            for key, leaf in layer.items()
        }
        for layer in params["layers"]
    ]
    out["unembed"] = quant(params["unembed"])
    if include_embed:
        out["embed"] = quantize_weight(params["embed"], axis=0)
    return out


def quantize_lm_specs(specs: dict, include_embed: bool = True) -> dict:
    """PartitionSpec-tree twin of `quantize_lm_weights(bits=8)`: each
    quantized leaf becomes a QuantizedWeight node whose w_i8 carries the
    original weight spec and whose scale carries the OUTPUT-axis component
    (the per-output-channel scale [n] shards with the columns it scales;
    contraction-sharded weights keep a replicated scale, applied after the
    local dot — scale multiplication commutes with the psum).

    Use to place or shard_map a quantized param tree: the node's aux data
    (axis) matches quantize_lm_weights' output, so tree structures
    line up for jax.device_put / shard_map in_specs. int8 only — int4's
    split-half packing is not shardable along the contraction axis.
    """
    from jax.sharding import PartitionSpec as P

    def q(spec):
        out_axis = spec[1] if len(spec) > 1 else None
        return QuantizedWeight(w_i8=spec, scale=P(out_axis), axis=1)

    out = dict(specs)
    out["layers"] = [
        {key: (q(leaf) if key in _LINEAR_KEYS else leaf)
         for key, leaf in layer.items()}
        for layer in specs["layers"]
    ]
    out["unembed"] = q(specs["unembed"])
    if include_embed:
        e = specs["embed"]
        row_axis = e[0] if len(e) > 0 else None
        out["embed"] = QuantizedWeight(w_i8=e, scale=P(row_axis), axis=0)
    return out


def mm(x: jnp.ndarray, w: Any) -> jnp.ndarray:
    """`x @ w` where w is a plain array, a QuantizedWeight (int8, axis=1),
    or a QuantizedWeight4 (packed int4 + group scales).

    Plain arrays take the ordinary XLA dot (training paths see zero
    change). Quantized weights dequantize in the dot's operand path; XLA
    fuses the convert (and the int4 unpack) into the GEMM's load, so the
    weight is read from device memory at its stored width.
    """
    if isinstance(w, QuantizedWeight4):
        return x @ w.dequantize(x.dtype)
    if not isinstance(w, QuantizedWeight):
        return x @ w
    if w.axis != w.w_i8.ndim - 1:
        raise ValueError("mm wants output-channel scales (axis=last)")
    return (x @ w.w_i8.astype(x.dtype)) * w.scale.astype(x.dtype)


def embedding_lookup(embed: Any, tokens: jnp.ndarray,
                     dtype=jnp.bfloat16) -> jnp.ndarray:
    """embed[tokens] for a plain table or a row-quantized QuantizedWeight.

    Quantized tables dequantize into `dtype` (default bf16 — the serving
    activation dtype). NOTE this sets the ACTIVATION precision of the whole
    quantized forward pass: x enters layer 0 in `dtype` and every mm
    returns x.dtype, so quantizing weights on f32 params runs bf16
    activations unless dtype=jnp.float32 is passed. Plain tables return
    their own dtype unchanged."""
    if not isinstance(embed, QuantizedWeight):
        return embed[tokens]
    if embed.axis != 0:
        raise ValueError("embedding_lookup wants per-row scales (axis=0)")
    rows = embed.w_i8[tokens].astype(dtype)
    return rows * embed.scale[tokens][..., None].astype(dtype)
