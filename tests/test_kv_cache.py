"""Quantized KV cache + decode attention tests."""

import jax
import jax.numpy as jnp

from quantizedattention_tpu.parallel import append_kv, decode_attention, init_kv_cache
from quantizedattention_tpu.reference import reference_attention
from quantizedattention_tpu.utils.testing import mismatch_report


def test_append_and_lengths(rng):
    cache = init_kv_cache(batch=2, n_kv_heads=2, max_len=512, head_dim=64)
    k1, k2 = jax.random.split(rng)
    k_new = jax.random.normal(k1, (2, 2, 100, 64))
    v_new = jax.random.normal(k2, (2, 2, 100, 64))
    cache = append_kv(cache, k_new, v_new)
    assert cache.length.tolist() == [100, 100]
    # appended region dequantizes back to within int8 step
    k_hat = cache.k_i8[:, :, :100].astype(jnp.float32) * cache.sk[:, :, :100, None]
    assert float(jnp.max(jnp.abs(k_hat - k_new))) < 0.05
    # un-touched tail stays zero
    assert int(jnp.abs(cache.k_i8[:, :, 100:]).max()) == 0


def test_decode_matches_oracle(rng):
    """Decode of one token == full attention's last-row output (GQA 8q/2kv)."""
    b, hq, hkv, t, d = 2, 8, 2, 300, 64
    kk, kv_, kq = jax.random.split(rng, 3)
    k = jax.random.normal(kk, (b, hkv, t, d))
    v = jax.random.normal(kv_, (b, hkv, t, d))
    q1 = jax.random.normal(kq, (b, hq, d))

    cache = init_kv_cache(b, hkv, max_len=512, head_dim=d)
    cache = append_kv(cache, k, v)
    o = decode_attention(q1, cache)
    assert o.shape == (b, hq, d)

    # oracle: repeat kv heads to GQA layout, single-query attention
    group = hq // hkv
    k_full = jnp.repeat(k, group, axis=1)
    v_full = jnp.repeat(v, group, axis=1)
    want = reference_attention(q1[:, :, None, :], k_full, v_full)[:, :, 0, :]
    rep = mismatch_report("decode", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep


def test_decode_respects_length(rng):
    """Tokens past `length` must not leak into the softmax."""
    b, hq, hkv, d = 1, 2, 2, 64
    kk, kv_, kq, kjunk = jax.random.split(rng, 4)
    k = jax.random.normal(kk, (b, hkv, 64, d))
    v = jax.random.normal(kv_, (b, hkv, 64, d))
    q1 = jax.random.normal(kq, (b, hq, d))

    cache_a = init_kv_cache(b, hkv, max_len=256, head_dim=d)
    cache_a = append_kv(cache_a, k, v)

    # cache_b has junk pre-written beyond length (simulates stale pages)
    cache_b = cache_a._replace(
        k_i8=cache_a.k_i8.at[:, :, 64:].set(7),
        sk=cache_a.sk.at[:, :, 64:].set(1.0),
        v_i8=cache_a.v_i8.at[:, :, 64:].set(-5),
        sv=cache_a.sv.at[:, :, 64:].set(1.0),
    )
    o_a = decode_attention(q1, cache_a)
    o_b = decode_attention(q1, cache_b)
    assert bool(jnp.allclose(o_a, o_b, atol=1e-6))


def test_incremental_decode_sequence(rng):
    """Append tokens one at a time; each decode sees exactly the prefix."""
    b, hq, hkv, d = 1, 4, 2, 64
    keys = jax.random.split(rng, 8)
    cache = init_kv_cache(b, hkv, max_len=128, head_dim=d)
    k_all = jax.random.normal(keys[0], (b, hkv, 16, d))
    v_all = jax.random.normal(keys[1], (b, hkv, 16, d))
    q1 = jax.random.normal(keys[2], (b, hq, d))

    cache = append_kv(cache, k_all[:, :, :10], v_all[:, :, :10])
    o10 = decode_attention(q1, cache)
    cache = append_kv(cache, k_all[:, :, 10:], v_all[:, :, 10:])
    o16 = decode_attention(q1, cache)

    group = hq // hkv
    for t, o in [(10, o10), (16, o16)]:
        k_full = jnp.repeat(k_all[:, :, :t], group, axis=1)
        v_full = jnp.repeat(v_all[:, :, :t], group, axis=1)
        want = reference_attention(q1[:, :, None, :], k_full, v_full)[:, :, 0, :]
        rep = mismatch_report(f"decode@{t}", o, want, atol=5e-2)
        assert rep.mismatch_rate <= 5e-3, rep


def test_decode_return_lse_merge_identity(rng):
    """Splitting a cache into two halves and merging the partials via lse
    must reproduce the unsharded decode (the context_sharded_decode math)."""
    b, h, max_len, d = 2, 4, 256, 64
    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (b, h, d), jnp.float32)
    k = jax.random.normal(kk, (b, h, 200, d), jnp.float32)
    v = jax.random.normal(kv, (b, h, 200, d), jnp.float32)
    cache = append_kv(init_kv_cache(b, h, max_len, d), k, v)
    want = decode_attention(q, cache)

    half = max_len // 2
    import quantizedattention_tpu.parallel.kv_cache as kvmod

    parts = []
    for c in range(2):
        local = kvmod.QuantizedKVCache(
            k_i8=cache.k_i8[:, :, c * half:(c + 1) * half],
            sk=cache.sk[:, :, c * half:(c + 1) * half],
            v_i8=cache.v_i8[:, :, c * half:(c + 1) * half],
            sv=cache.sv[:, :, c * half:(c + 1) * half],
            length=jnp.clip(cache.length - c * half, 0, half),
        )
        parts.append(decode_attention(q, local, return_lse=True))
    (o1, l1), (o2, l2) = parts
    m = jnp.maximum(l1, l2)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    w1 = jnp.where(jnp.isfinite(l1), jnp.exp2(l1 - m_safe), 0.0)
    w2 = jnp.where(jnp.isfinite(l2), jnp.exp2(l2 - m_safe), 0.0)
    den = jnp.where(w1 + w2 == 0.0, 1.0, w1 + w2)
    got = (o1 * w1[..., None] + o2 * w2[..., None]) / den[..., None]
    assert jnp.max(jnp.abs(got - want)) < 2e-3  # bf16-rate dots: split boundaries shift bf16 rounding


def test_context_sharded_decode_matches_unsharded(rng):
    """Sequence-sharded decode over a 4-device context mesh == unsharded."""
    import functools

    import numpy as np
    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel import context_sharded_decode, make_attention_mesh

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs 4 emulated devices")
    b, n_q, n_kv, max_len, d = 2, 8, 4, 512, 64  # GQA group of 2
    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (b, n_q, d), jnp.float32)
    k = jax.random.normal(kk, (b, n_kv, 300, d), jnp.float32)
    v = jax.random.normal(kv, (b, n_kv, 300, d), jnp.float32)
    cache = append_kv(init_kv_cache(b, n_kv, max_len, d), k, v)
    # different live lengths per row
    cache = cache._replace(length=jnp.asarray([300, 137], jnp.int32))
    want = decode_attention(q, cache)

    mesh = make_attention_mesh(data=1, model=1, context=4)
    cache_spec = type(cache)(
        k_i8=P(None, None, "context", None), sk=P(None, None, "context"),
        v_i8=P(None, None, "context", None), sv=P(None, None, "context"),
        length=P(),
    )

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), cache_spec), out_specs=P(),
        check_vma=False,
    )
    def sharded(q_, cache_):
        return context_sharded_decode(q_, cache_, "context")

    got = sharded(q, cache)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3)  # bf16-rate dots


def test_decode_attention_head_dim_128_gqa(rng):
    """d=128 decode with GQA groups — full head-dim contraction through
    the lane-aligned scale layout."""
    from quantizedattention_tpu.parallel.kv_cache import (
        append_kv, decode_attention, init_kv_cache,
    )
    from quantizedattention_tpu.reference import reference_attention

    cache = init_kv_cache(2, 2, 256, 128)
    k = jax.random.normal(jax.random.key(50), (2, 2, 200, 128))
    v = jax.random.normal(jax.random.key(51), (2, 2, 200, 128))
    cache = append_kv(cache, k, v)
    q = jax.random.normal(jax.random.key(52), (2, 4, 128))  # 4 q / 2 kv heads
    o = decode_attention(q, cache)
    k_r, v_r = jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1)
    want = reference_attention(q[:, :, None, :], k_r, v_r, causal=False)[:, :, 0]
    assert float(jnp.max(jnp.abs(o - want))) < 5e-2
