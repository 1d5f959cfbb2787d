"""GQA-native kernel tests: unrepeated-KV prefill/training paths.

The decode was GQA-native from round 2 (parallel/kv_cache.py); round 4
extends the prefill/training kernels to take unrepeated K/V directly —
the q group folds into the rows of each q tile, so one K/V tile load serves
the whole group, cutting K/V reads and (for int8) quantize work rep-fold vs
a jnp.repeat boundary. No reference counterpart (its kernels are
single-head-count, attention_bf16.py:107); parity oracle = the repeated-KV
path and jax.grad of the fp32 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.reference import reference_attention


def _qkv(key, B, H, HKV, T, D, tkv=None, dtype=jnp.float32):
    kq, kk, kv, kd = jax.random.split(key, 4)
    tkv = T if tkv is None else tkv
    q = jax.random.normal(kq, (B, H, T, D), dtype)
    k = jax.random.normal(kk, (B, HKV, tkv, D), dtype)
    v = jax.random.normal(kv, (B, HKV, tkv, D), dtype)
    do = jax.random.normal(kd, (B, H, T, D), jnp.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_gqa_fwd_matches_repeated(causal, precision):
    q, k, v, _ = _qkv(jax.random.key(0), 2, 8, 2, 384, 64)
    rep = 4
    o_g, lse_g = flash_attention_fwd(q, k, v, causal=causal, precision=precision)
    o_r, lse_r = flash_attention_fwd(
        q, jnp.repeat(k, rep, 1), jnp.repeat(v, rep, 1),
        causal=causal, precision=precision,
    )
    np.testing.assert_allclose(np.asarray(o_g), np.asarray(o_r), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(lse_g), np.asarray(lse_r), atol=1e-6, rtol=0)


def test_gqa_fwd_cross_lengths():
    q, k, v, _ = _qkv(jax.random.key(1), 1, 4, 2, 77, 64, tkv=201)
    o_g, _ = flash_attention_fwd(q, k, v, causal=False)
    o_r, _ = flash_attention_fwd(
        q, jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1), causal=False
    )
    np.testing.assert_allclose(np.asarray(o_g), np.asarray(o_r), atol=1e-6, rtol=0)


def test_gqa_rejects_bad_ratio():
    q, k, v, _ = _qkv(jax.random.key(2), 1, 6, 4, 128, 64)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_bwd_matches_grad_oracle(causal):
    q, k, v, do = _qkv(jax.random.key(3), 2, 8, 2, 384, 64)
    rep = 4
    o, lse = flash_attention_fwd(q, k, v, causal=causal, precision="fp32")
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

    def loss(q_, k_, v_):
        kr, vr = jnp.repeat(k_, rep, 1), jnp.repeat(v_, rep, 1)
        return jnp.vdot(reference_attention(q_, kr, vr, causal=causal), do)

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    assert dk.shape == k.shape and dv.shape == v.shape
    np.testing.assert_allclose(np.asarray(dq), np.asarray(gq), atol=2e-3, rtol=0)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(gk), atol=2e-3, rtol=0)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(gv), atol=2e-3, rtol=0)


def test_gqa_bf16_custom_vjp_grads():
    q, k, v, do = _qkv(jax.random.key(4), 2, 8, 2, 256, 64, dtype=jnp.bfloat16)
    rep = 4

    def loss(q_, k_, v_):
        return jnp.vdot(flash_attention_bf16(q_, k_, v_, causal=True), do)

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    assert gk.shape == k.shape and gv.shape == v.shape

    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))

    def oracle(q_, k_, v_):
        kr, vr = jnp.repeat(k_, rep, 1), jnp.repeat(v_, rep, 1)
        return jnp.vdot(reference_attention(q_, kr, vr, causal=True), do)

    oq, ok, ov = jax.grad(oracle, argnums=(0, 1, 2))(qf, kf, vf)
    for got, want in ((gq, oq), (gk, ok), (gv, ov)):
        scale = float(jnp.max(jnp.abs(want)))
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
        assert err / scale < 2e-2, (err, scale)


def test_gqa_int8_inference_matches_training_forward():
    """The inference wrapper (quantize, then the int8 kernel, no residuals
    kept) under GQA: must equal the training forward with the same
    K-smoothing shift bit for bit (one kernel serves both)."""
    from quantizedattention_tpu.ops.api import sage_attention_int8_inference
    from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd

    q, k, v, _ = _qkv(jax.random.key(6), 2, 8, 2, 256, 64)
    o_i = sage_attention_int8_inference(q, k, v, causal=True)
    o_m, _, _ = int8_attention_fwd(q, k, v, causal=True,
                                   k_sub=jnp.mean(k, axis=-2, keepdims=True))
    np.testing.assert_array_equal(np.asarray(o_i), np.asarray(o_m))


def test_gqa_int8_cross_lengths():
    q, k, v, _ = _qkv(jax.random.key(7), 1, 4, 2, 256, 64, tkv=384)
    from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
    from quantizedattention_tpu.tune.config import default_block_config

    cfg = default_block_config("int8", 256, 384, 64)
    o_g, _, _ = int8_attention_fwd(q, k, v, causal=False, config=cfg)
    # the repeated path quantizes Q at the grain the GQA fold chose
    o_r, _, _ = int8_attention_fwd(
        q, jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1), causal=False,
        config=cfg.for_group(2),
    )
    np.testing.assert_allclose(np.asarray(o_g), np.asarray(o_r), atol=1e-5, rtol=0)


def test_mqa_single_kv_head():
    """MQA edge (h_kv=1, rep=8): fwd + custom_vjp grads vs the repeated
    path — the largest group the models here can produce."""
    q, k, v, do = _qkv(jax.random.key(8), 1, 8, 1, 256, 64, dtype=jnp.bfloat16)

    def loss_g(q_, k_, v_):
        return jnp.vdot(flash_attention_bf16(q_, k_, v_, causal=True), do)

    def loss_r(q_, k_, v_):
        kr, vr = jnp.repeat(k_, 8, 1), jnp.repeat(v_, 8, 1)
        return jnp.vdot(flash_attention_bf16(q_, kr, vr, causal=True), do)

    (lg, (gq, gk, gv)) = jax.value_and_grad(loss_g, argnums=(0, 1, 2))(q, k, v)
    (lr, (rq, rk, rv)) = jax.value_and_grad(loss_r, argnums=(0, 1, 2))(q, k, v)
    assert gk.shape == k.shape
    np.testing.assert_allclose(float(lg), float(lr), rtol=1e-5)
    # grads are bf16: the rep-grouped tiles round differently from the
    # repeated-head tiles at the last bit — compare at bf16-ulp scale
    # (same criterion as test_gqa_bf16_custom_vjp_grads)
    for got, want in ((gq, rq), (gk, rk), (gv, rv)):
        g32, w32 = np.asarray(got, np.float32), np.asarray(want, np.float32)
        scale = float(np.max(np.abs(w32)))
        assert float(np.max(np.abs(g32 - w32))) / scale < 2e-2


def test_for_group_caps_folded_rows():
    """GQA folds the q group into the rows of a q tile; for_group shrinks
    block_q so group x block_q stays within MAX_ROWS (never below
    MIN_BLOCK), leaves the kv tiles alone, and is idempotent."""
    from quantizedattention_tpu.tune.config import MAX_ROWS, MIN_BLOCK, BlockConfig

    cfg = BlockConfig(block_q=128, block_kv=64, block_q_bwd=64, block_kv_bwd=64)
    assert cfg.for_group(1) == cfg
    # d > 64: the backward/int8 row cap halves the q tile even without GQA
    assert cfg.for_group(1, rows=64).block_q == 64
    for rep, want in ((2, 64), (3, 32), (4, 32), (8, 16), (16, MIN_BLOCK), (64, MIN_BLOCK)):
        c = cfg.for_group(rep)
        assert c.block_q == want, (rep, c)
        assert c.block_q_bwd == min(64, want), (rep, c)
        assert (c.block_kv, c.block_kv_bwd) == (64, 64)
        assert c.for_group(rep) == c
        if want > MIN_BLOCK:
            group = 1 << (rep - 1).bit_length()
            assert group * c.block_q <= MAX_ROWS


def test_mqa_large_rep_long_seq_clamps_and_matches():
    """rep=16 at T=1024: for_group shrinks block_q to the 16-row floor (the
    folded group fills the rows); this pins the shrunk tiling's correctness
    (fwd + custom_vjp grads, and int8 where the quantization grain must
    track it) against the repeated-KV path."""
    q, k, v, do = _qkv(jax.random.key(9), 1, 16, 1, 1024, 64, dtype=jnp.bfloat16)

    def loss_g(q_, k_, v_):
        return jnp.vdot(flash_attention_bf16(q_, k_, v_, causal=True), do)

    def loss_r(q_, k_, v_):
        kr, vr = jnp.repeat(k_, 16, 1), jnp.repeat(v_, 16, 1)
        return jnp.vdot(flash_attention_bf16(q_, kr, vr, causal=True), do)

    (lg, (gq, gk, gv)) = jax.value_and_grad(loss_g, argnums=(0, 1, 2))(q, k, v)
    (lr, (rq, rk, rv)) = jax.value_and_grad(loss_r, argnums=(0, 1, 2))(q, k, v)
    assert gk.shape == k.shape
    np.testing.assert_allclose(float(lg), float(lr), rtol=1e-5)
    for got, want in ((gq, rq), (gk, rk), (gv, rv)):
        g32, w32 = np.asarray(got, np.float32), np.asarray(want, np.float32)
        scale = float(np.max(np.abs(w32)))
        assert float(np.max(np.abs(g32 - w32))) / scale < 2e-2

    # int8: quantize_qkv's q grain, the fwd kernel, and the residual-derived
    # backward must all land on the same shrunk block_q. The oracle run
    # pins the SAME grain explicitly (for_group is a no-op at rep=1), since
    # a different q-quantization grain changes the scales themselves.
    from quantizedattention_tpu.tune.config import default_block_config

    cfg = default_block_config("int8", 1024, 1024, 64).for_group(16)
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    o_g = sage_attention_int8(qf, kf, vf, causal=True)  # for_group picks cfg's grain
    o_r = sage_attention_int8(
        qf, jnp.repeat(kf, 16, 1), jnp.repeat(vf, 16, 1), causal=True,
        config=cfg,
    )
    np.testing.assert_allclose(np.asarray(o_g), np.asarray(o_r), atol=1e-5, rtol=0)


def test_gqa_int8_matches_repeated():
    from quantizedattention_tpu.tune.config import default_block_config

    q, k, v, do = _qkv(jax.random.key(5), 2, 8, 2, 256, 64)
    rep = 4
    cfg = default_block_config("int8", 256, 256, 64).for_group(rep)

    def loss_g(q_, k_, v_):
        return jnp.vdot(sage_attention_int8(q_, k_, v_, causal=True), do)

    def loss_r(q_, k_, v_):
        kr, vr = jnp.repeat(k_, rep, 1), jnp.repeat(v_, rep, 1)
        # same q-quantization grain as the folded GQA path
        return jnp.vdot(sage_attention_int8(q_, kr, vr, causal=True, config=cfg), do)

    (lg, (gq, gk, gv)) = jax.value_and_grad(loss_g, argnums=(0, 1, 2))(q, k, v)
    # oracle: repeat OUTSIDE the kernel; jax.grad of jnp.repeat already
    # group-sums the cotangent back to kv-head count
    (lr, (rq, rk, rv)) = jax.value_and_grad(loss_r, argnums=(0, 1, 2))(q, k, v)
    assert gk.shape == k.shape and rk.shape == k.shape
    # The GQA path quantizes the UNREPEATED K/V (one block scale per kv head)
    # while the repeated path quantizes per q head — identical values, so the
    # block absmax/scales coincide and outputs agree to f32 roundoff.
    np.testing.assert_allclose(float(lg), float(lr), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gq), np.asarray(rq), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(rk), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(rv), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rep,t,block_q", [(1, 100, 32), (3, 77, 16), (4, 128, 32), (8, 40, 16)])
def test_fold_group_roundtrip(rep, t, block_q):
    """GQA row folding pads the group to a power of two and t to whole
    tiles; row r of a tile is head r // block_q at token r % block_q, and
    unfold_group inverts it exactly."""
    from quantizedattention_tpu.ops.common import fold_group, unfold_group

    b, kv = 2, 2
    x = jax.random.normal(jax.random.key(rep), (b, kv * rep, t, 16))
    f = fold_group(x, kv, block_q)
    group = 1 << (rep - 1).bit_length()
    nq = -(-t // block_q)
    assert f.shape == (b * kv, nq, group * block_q, 16)
    # tile 0, row g*block_q + i holds head (kv 0, g) at token i
    np.testing.assert_array_equal(np.asarray(f[0, 0, (rep - 1) * block_q + 1]),
                                  np.asarray(x[0, rep - 1, 1]))
    np.testing.assert_array_equal(np.asarray(unfold_group(f, b, kv * rep, t)), np.asarray(x))


def test_exact_modes_route_to_plain_jax():
    """The IEEE-f32 modes run plain JAX (ops/plain.py) — the Triton route's
    f32 dots lost to XLA on the card — and the bf16/fast modes run the
    kernels; the plain paths handle GQA and offsets themselves."""
    from quantizedattention_tpu.ops import plain

    q, k, v, do = _qkv(jax.random.key(11), 1, 4, 2, 96, 32)
    o, lse = flash_attention_fwd(q, k, v, causal=True, precision="fp32", q_offset=32)
    o_p, lse_p = plain.attention_fwd(q, k, v, causal=True, q_offset=32)
    np.testing.assert_array_equal(np.asarray(o), np.asarray(o_p))
    np.testing.assert_array_equal(np.asarray(lse), np.asarray(lse_p))
    g = flash_attention_bwd(q, k, v, o, lse, do, causal=True, q_offset=32)
    g_p = plain.attention_bwd(q, k, v, o, lse, do, causal=True, q_offset=32)
    for a, b in zip(g, g_p):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the kernel path (bf16) differs from the f32 plain path by bf16 rounding
    o_k, _ = flash_attention_fwd(q, k, v, causal=True, q_offset=32)
    assert 0 < float(jnp.max(jnp.abs(o_k - o_p))) < 2e-2
