"""INT8 (SageAttention3-style) attention vs the fp32 oracle (fwd + bwd).

The reference never recorded int8 accuracy numbers (its tests print MSE only,
attention_int8.py:543-612, and its fwd mixes keys across batch/head —
SURVEY.md §2.3 Q4 — so its printed numbers are not a meaningful envelope).
Tolerances here are set from the quantization error budget: int8 per-block
symmetric quantization at d=64, unit-normal inputs.
"""

import jax
import jax.numpy as jnp
import pytest

from quantizedattention_tpu import int8_attention_fwd, sage_attention_int8


def test_causal_mask_holds_for_tiny_magnitude_inputs(rng):
    """Code-review regression: the raw-domain mask sentinel must underflow
    for ANY quantization scale. With q,k ~ N(0, 0.01^2) the dequant scale c
    is ~1e-9; a fixed raw sentinel would leave masked (future) positions
    with ~0.4 relative weight and the causal output would silently attend
    to the future."""
    from quantizedattention_tpu.reference import reference_attention
    from quantizedattention_tpu.utils.testing import mismatch_report
    from tests.conftest import make_qkv

    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    q, k = q * 0.01, k * 0.01
    o, _, _ = int8_attention_fwd(q, k, v, causal=True)
    want = reference_attention(q, k, v, causal=True)
    rep = mismatch_report("tiny-scale causal int8", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep
from quantizedattention_tpu.reference import reference_attention, reference_attention_vjp
from quantizedattention_tpu.utils.testing import mismatch_report
from tests.conftest import make_qkv


@pytest.mark.parametrize("causal", [False, True])
def test_forward_int8(rng, causal):
    q, k, v, _ = make_qkv(rng, batch=2, head=2, q_tokens=256)
    o, lse, residuals = int8_attention_fwd(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report("int8 fwd", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep
    assert not bool(jnp.any(jnp.isnan(o)))
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    assert q_i8.dtype == jnp.int8 and k_i8.dtype == jnp.int8 and v_i8.dtype == jnp.int8
    assert sq.shape[-1] == q_i8.shape[1] // 256 or sq.shape[-1] >= 1


def test_forward_int8_k_smoothing_helps(rng):
    """With a large K mean, the smoothed path (public API) must beat the raw
    int8 path — this is the point of K-smoothing (SageAttention3)."""
    kq, kk, kv = jax.random.split(rng, 3)
    q = jax.random.normal(kq, (1, 2, 256, 64))
    k = jax.random.normal(kk, (1, 2, 256, 64)) + 6.0  # large common-mode mean
    v = jax.random.normal(kv, (1, 2, 256, 64))
    want = reference_attention(q, k, v)
    o_smoothed = sage_attention_int8(q, k, v)
    o_raw, _, _ = int8_attention_fwd(q, k, v)
    mse_smoothed = float(jnp.mean((o_smoothed - want) ** 2))
    mse_raw = float(jnp.mean((o_raw - want) ** 2))
    assert mse_smoothed < mse_raw, (mse_smoothed, mse_raw)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_int8_vs_autodiff_oracle(rng, causal):
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=256)

    def loss(q_, k_, v_):
        return jnp.sum(sage_attention_int8(q_, k_, v_, causal=causal) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    # int8 gradients are approximate (quantized dS/dO/P); assert relative
    # error of the full gradient tensors stays within a few percent.
    for name, got, want in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rel = float(
            jnp.linalg.norm(got - want) / jnp.maximum(jnp.linalg.norm(want), 1e-6)
        )
        assert rel <= 0.06, f"{name} rel_err={rel}"
        assert not bool(jnp.any(jnp.isnan(got))), name


def test_int8_cross_lengths(rng):
    """Distinct q/kv token counts — forced by SURVEY.md §2.3 Q5."""
    q, k, v, _ = make_qkv(rng, q_tokens=128, kv_tokens=384)
    o, _, _ = int8_attention_fwd(q, k, v)
    want = reference_attention(q, k, v)
    rep = mismatch_report("int8 cross", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep


@pytest.mark.parametrize("causal", [False, True])
def test_fused_inference_forward_matches_materialized(rng, causal):
    """The inference path (sage_attention_int8_inference) and the training
    forward share one kernel and one quantization pass: with the same
    K-smoothing shift they must agree bit for bit, lse included."""
    from quantizedattention_tpu import sage_attention_int8_inference

    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    k_mean = jnp.mean(k, axis=-2, keepdims=True)
    o_f = sage_attention_int8_inference(q, k, v, causal=causal)
    o_m, _, _ = int8_attention_fwd(q, k, v, causal=causal, k_sub=k_mean)
    assert float(jnp.max(jnp.abs(o_f - o_m))) == 0.0


def test_fused_inference_cross_lengths_and_smoothing(rng):
    from quantizedattention_tpu import sage_attention_int8_inference

    q, k, v, _ = make_qkv(rng, q_tokens=128, kv_tokens=384)
    o = sage_attention_int8_inference(q, k, v, smooth_k=False)
    want = reference_attention(q, k, v)
    rep = mismatch_report("int8 inference cross", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep

    # public wrapper with K-smoothing: a large common K component must not
    # blow up the quantization error (softmax shift invariance means no
    # output compensation is needed)
    k_shift = k + 8.0
    o_s = sage_attention_int8_inference(q, k_shift, v)
    want_s = reference_attention(q, k_shift, v)
    rep_s = mismatch_report("int8 inference smoothed", o_s, want_s, atol=5e-2)
    assert rep_s.mismatch_rate <= 2e-3, rep_s


def test_int8_p_quantization_per_row(rng):
    """P is quantized per row of each kv tile (the row's largest entry maps
    to 127): with q = 0 every logit ties, every P entry quantizes to exactly
    127, and the output is the plain mean of the (int8-quantized) values."""
    _, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=256)
    q = jnp.zeros((1, 1, 256, 64))
    o, _, _ = int8_attention_fwd(q, k, v)
    want = jnp.broadcast_to(jnp.mean(v, axis=2, keepdims=True), o.shape)
    # V quantizes per kv tile: each element moves by at most scale / 2
    assert float(jnp.max(jnp.abs(o - want))) <= float(jnp.max(jnp.abs(v))) / 254 + 1e-6


@pytest.mark.parametrize("head_dim", [64, 128])
def test_int8_backward_launch_shape(monkeypatch, rng, head_dim):
    """Both backward passes launch with 2 stages and 4 warps at every head
    dim, whatever the forward's config takes (8 warps at d=128), and tile
    at the forward's quantization grain (64 rows at d=128)."""
    from quantizedattention_tpu.ops import int8_bwd

    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=128, head_dim=head_dim)
    launches = []
    real = int8_bwd.triton_call

    def spy(kernel, **kw):
        launches.append((kw["name"], kw["config"].num_warps, kw["config"].num_stages,
                         kernel.keywords["block_q"]))
        return real(kernel, **kw)

    monkeypatch.setattr(int8_bwd, "triton_call", spy)
    jax.grad(lambda q_: jnp.sum(sage_attention_int8(q_, k, v) * do))(q)
    block_q = 64 if head_dim > 64 else 128
    assert launches == [("int8_bwd_dkv", 4, 2, block_q), ("int8_bwd_dq", 4, 2, block_q)]
