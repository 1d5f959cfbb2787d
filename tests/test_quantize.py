"""Unit tests for the numerics core (quantize/)."""

import jax
import jax.numpy as jnp
import numpy as np

from quantizedattention_tpu.quantize import (
    absmax_scale,
    amplify_tied_max,
    dequantize_int8,
    k_smooth,
    quantize_int8,
    quantize_int8_blocks,
)
from quantizedattention_tpu.reference import reference_attention


def test_quantize_roundtrip(rng):
    x = jax.random.normal(rng, (64, 32), jnp.float32) * 5.0
    s = absmax_scale(x)
    x_i8 = quantize_int8(x, s)
    x_hat = dequantize_int8(x_i8, s)
    # round-to-nearest: error bounded by half a quantization step
    assert float(jnp.max(jnp.abs(x - x_hat))) <= float(s) * 0.5 + 1e-6
    assert x_i8.dtype == jnp.int8


def test_quantize_blocks_shapes(rng):
    x = jax.random.normal(rng, (3, 256, 64), jnp.float32)
    x_i8, scales = quantize_int8_blocks(x, 128)
    assert x_i8.shape == x.shape and x_i8.dtype == jnp.int8
    assert scales.shape == (3, 2)
    # each block uses its own scale: max |int8| should be 127 in every block
    blocks = np.asarray(x_i8).reshape(3, 2, 128, 64)
    assert (np.abs(blocks).reshape(3, 2, -1).max(-1) == 127).all()


def test_quantize_qkv_tiles_match_block_oracle(rng):
    """The int8 attention's quantization pass (ops/int8_fwd.quantize_qkv,
    plain jnp) matches quantize_int8_blocks per tile: K/V at the kv tile,
    Q at the q tile with each tile's scale repeated over its rows, and the
    K-smoothing shift applied before quantization."""
    from quantizedattention_tpu.ops.int8_fwd import quantize_qkv
    from quantizedattention_tpu.tune.config import BlockConfig

    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (1, 2, 128, 64), jnp.float32) * 7.0
    k = jax.random.normal(kk, (1, 2, 192, 64), jnp.float32) + 3.0
    v = jax.random.normal(kv, (1, 2, 192, 64), jnp.float32)
    k_sub = jnp.mean(k, axis=2, keepdims=True)
    cfg = BlockConfig(block_q=32, block_kv=64)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = quantize_qkv(q, k, v, cfg, k_sub=k_sub)

    ref_k, ref_sk = quantize_int8_blocks((k - k_sub).reshape(2, 192, 64), 64)
    np.testing.assert_array_equal(np.asarray(k_i8), np.asarray(ref_k))
    np.testing.assert_allclose(np.asarray(sk), np.asarray(ref_sk), rtol=1e-7)
    ref_v, ref_sv = quantize_int8_blocks(v.reshape(2, 192, 64), 64)
    np.testing.assert_array_equal(np.asarray(v_i8), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(sv), np.asarray(ref_sv), rtol=1e-7)
    ref_q, ref_sq = quantize_int8_blocks(q.reshape(2, 128, 64), 32)
    # rep = 1: the folded layout is [b·h, n_q_tiles, block_q, d]
    np.testing.assert_array_equal(np.asarray(q_i8).reshape(2, 128, 64), np.asarray(ref_q))
    np.testing.assert_allclose(np.asarray(sq).reshape(2, 4, 32),
                               np.repeat(np.asarray(ref_sq)[:, :, None], 32, axis=2),
                               rtol=1e-7)


def test_quantize_zero_tile_safe():
    x = jnp.zeros((8, 8), jnp.float32)
    s = absmax_scale(x)
    x_i8 = quantize_int8(x, s)
    assert not bool(jnp.any(jnp.isnan(dequantize_int8(x_i8, s))))
    assert int(jnp.abs(x_i8).max()) == 0


def test_k_smoothing_invariance(rng):
    """Softmax attention is exactly invariant to K-smoothing (pre-quantization)."""
    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (1, 2, 64, 32))
    k = jax.random.normal(kk, (1, 2, 64, 32)) + 3.0  # nonzero mean matters
    v = jax.random.normal(kv, (1, 2, 64, 32))
    k_sm, k_mean = k_smooth(k)
    assert k_mean.shape == (1, 2, 1, 32)
    np.testing.assert_allclose(
        reference_attention(q, k, v), reference_attention(q, k_sm, v), atol=1e-5
    )


def test_amplify_tied_max():
    # two logits tied at the (positive) max -> amplified by BETA
    s = jnp.array([[5.0, 5.0, 1.0]])
    m = jnp.array([[5.0]])
    out = amplify_tied_max(s, m)
    assert float(out[0, 0]) == 10.0
    # negative tied max -> clamped to 0
    s = jnp.array([[-2.0, -2.0, -4.0]])
    m = jnp.array([[-2.0]])
    assert float(amplify_tied_max(s, m)[0, 0]) == 0.0
    # unique max -> untouched
    s = jnp.array([[5.0, 3.0, 1.0]])
    m = jnp.array([[5.0]])
    assert float(amplify_tied_max(s, m)[0, 0]) == 5.0


def test_eps_bias_keeps_bf16_p_below_one():
    """The zero-cost "eps" rule's guarantee: exp2(-EPS_BIAS) rounds to a bf16
    value strictly below 1.0, so no un-normalized P entry can hit 1.0."""
    from quantizedattention_tpu.quantize.bf16_correction import EPS_BIAS

    p_max = jnp.exp2(jnp.float32(-EPS_BIAS)).astype(jnp.bfloat16)
    assert float(p_max) < 1.0
    # and a tied logit 1e-3 below the max stays below 1.0 too
    p_tied = jnp.exp2(jnp.float32(-EPS_BIAS - 1e-3)).astype(jnp.bfloat16)
    assert float(p_tied) < 1.0
