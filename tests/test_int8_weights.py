"""Weight-only int8/int4 quantization: per-channel and group scheme, the
XLA dequant matmul (`mm`), model-level logits accuracy, and the engine's
weight_quant wiring.

No reference counterpart (the reference quantizes attention operands only
— attention_int8.py:97-263); this extends the serving stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.models import TransformerConfig, generate, init_transformer, transformer_forward
from quantizedattention_tpu.quantize.int4 import pack_int4, unpack_int4
from quantizedattention_tpu.quantize import (
    QuantizedWeight,
    QuantizedWeight4,
    embedding_lookup,
    mm,
    quantize_lm_weights,
    quantize_weight,
    quantize_weight_int4,
)


def test_per_channel_roundtrip_bound():
    """|dequant - w| <= scale/2 per element, scale = column absmax / 127."""
    w = jax.random.normal(jax.random.key(0), (96, 200)) * jnp.exp(
        jax.random.normal(jax.random.key(1), (1, 200))  # wildly varied columns
    )
    qw = quantize_weight(w)
    err = jnp.abs(qw.dequantize() - w)
    assert qw.w_i8.dtype == jnp.int8 and qw.scale.dtype == jnp.float32
    assert float(jnp.max(err / qw.scale[None, :])) <= 0.5 + 1e-3


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (5, 96, 200), (8, 1024, 512),
                                   (300, 256, 384)])
def test_mm_int8_matches_dequant_reference(m, k, n):
    """mm on an int8 weight == the f32 dequant matmul, at any (un)aligned
    shape (the int8 payload converts exactly; the scale applies per output
    column after the dot)."""
    x = jax.random.normal(jax.random.key(2), (m, k), jnp.float32)
    w = jax.random.normal(jax.random.key(3), (k, n), jnp.float32)
    qw = quantize_weight(w)
    ref = (x @ qw.w_i8.astype(jnp.float32)) * qw.scale
    got = mm(x, qw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-4 * float(jnp.max(jnp.abs(ref))))


def test_mm_dispatch_and_xla_arm():
    """mm passes plain arrays through as x @ w; a quantized weight keeps
    x's leading dims and dtype and agrees with the dequantized weight
    within bf16 output rounding."""
    x = jax.random.normal(jax.random.key(4), (4, 7, 128), jnp.bfloat16)
    w = jax.random.normal(jax.random.key(5), (128, 256), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(mm(x, w.astype(jnp.bfloat16))),
        np.asarray(x @ w.astype(jnp.bfloat16)),
    )
    qw = quantize_weight(w)
    a = mm(x, qw)
    assert a.shape == (4, 7, 256) and a.dtype == jnp.bfloat16
    b = x.astype(jnp.float32) @ qw.dequantize()
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b),
                               atol=2e-2 * float(jnp.max(jnp.abs(b))))


def test_quantized_embedding_lookup():
    e = jax.random.normal(jax.random.key(6), (64, 32))
    qe = quantize_weight(e, axis=0)
    toks = jnp.array([[0, 3], [63, 1]])
    got = embedding_lookup(qe, toks)
    want = e[toks]
    assert got.shape == (2, 2, 32)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               atol=2e-2 * float(jnp.max(jnp.abs(e))))
    with pytest.raises(ValueError, match="per-row"):
        embedding_lookup(quantize_weight(e, axis=1), toks)


def test_int4_pack_roundtrip():
    """pack/unpack reconstructs every nibble value in [-8, 7] exactly."""
    w4 = jnp.arange(-8, 8, dtype=jnp.int8).reshape(16, 1) * jnp.ones(
        (1, 4), jnp.int8
    )
    lo, hi = unpack_int4(pack_int4(w4))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(w4[:8], np.int32))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(w4[8:], np.int32))


def test_int4_group_roundtrip_bound():
    """|dequant - w| <= group_scale/2 per element, scale = group absmax/7."""
    w = jax.random.normal(jax.random.key(7), (512, 96)) * jnp.exp(
        jax.random.normal(jax.random.key(8), (1, 96))
    )
    qw = quantize_weight_int4(w, group=128)
    assert qw.packed.shape == (256, 96) and qw.scale.shape == (4, 96)
    err = jnp.abs(qw.dequantize() - w)
    # err[r, c] <= scale[r // g, c] / 2
    s_full = jnp.repeat(qw.scale, 128, axis=0)
    assert float(jnp.max(err / s_full)) <= 0.5 + 1e-3


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 1024, 512), (300, 200, 96)])
def test_mm_int4_matches_dequant_reference(m, k, n):
    """mm on an int4 weight == bf16-activation dequant matmul, including
    k not a multiple of 2*group (padded contraction)."""
    x = jax.random.normal(jax.random.key(9), (m, k), jnp.float32)
    w = jax.random.normal(jax.random.key(10), (k, n), jnp.float32)
    qw = quantize_weight_int4(w, group=128)
    ref = (
        x.astype(jnp.bfloat16).astype(jnp.float32) @ qw.dequantize()
    )
    got = mm(x, qw).astype(jnp.float32)
    assert got.shape == (m, n)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref),
        rtol=2e-2, atol=2e-2 * float(jnp.max(jnp.abs(ref))),
    )


def test_mm_rejects_row_scaled_weight():
    """A per-row (embedding-style) int8 weight has no output-column scale
    to apply after the dot: mm refuses it."""
    x = jnp.zeros((4, 32), jnp.float32)
    with pytest.raises(ValueError, match="output-channel"):
        mm(x, quantize_weight(jnp.ones((32, 64)), axis=0))


@pytest.fixture(scope="module")
def lm():
    cfg = TransformerConfig(
        vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64,
        n_layers=2, max_seq=128, attention="bf16",
    )
    return init_transformer(jax.random.key(0), cfg), cfg


def test_lm_tree_structure_and_forward_accuracy(lm):
    """quantize_lm_weights: linears + unembed + embed become QuantizedWeight,
    norms stay float; full-model logits stay close to the f32 model."""
    params, cfg = lm
    qparams = quantize_lm_weights(params)
    layer = qparams["layers"][0]
    for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
        assert isinstance(layer[key], QuantizedWeight)
    assert isinstance(qparams["unembed"], QuantizedWeight)
    assert isinstance(qparams["embed"], QuantizedWeight) and qparams["embed"].axis == 0
    assert not isinstance(layer["ln1"], QuantizedWeight)
    assert not isinstance(qparams["final_norm"], QuantizedWeight)

    tokens = jnp.array([[1, 2, 3, 4, 5, 6, 7, 8]], jnp.int32)
    full = transformer_forward(params, tokens, cfg)
    quant = transformer_forward(qparams, tokens, cfg)
    scale = float(jnp.max(jnp.abs(full)))
    assert float(jnp.max(jnp.abs(quant.astype(jnp.float32) - full))) < 0.05 * scale


def test_lm_int4_forward_accuracy(lm):
    """bits=4: linears+unembed become QuantizedWeight4, embed stays int8
    per-row; logits track the f32 model within int4's coarser budget."""
    params, cfg = lm
    qparams = quantize_lm_weights(params, bits=4)
    layer = qparams["layers"][0]
    for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
        assert isinstance(layer[key], QuantizedWeight4)
    assert isinstance(qparams["unembed"], QuantizedWeight4)
    assert isinstance(qparams["embed"], QuantizedWeight)  # gather path: int8

    tokens = jnp.array([[1, 2, 3, 4, 5, 6, 7, 8]], jnp.int32)
    full = transformer_forward(params, tokens, cfg)
    quant = transformer_forward(qparams, tokens, cfg).astype(jnp.float32)
    # The KERNEL must match the same model with explicitly dequantized
    # weights tightly (isolates kernel error from quantization error) ...
    deq_tree = jax.tree_util.tree_map(
        lambda x: x.dequantize(jnp.float32)
        if isinstance(x, (QuantizedWeight, QuantizedWeight4))
        else x,
        qparams,
        is_leaf=lambda x: isinstance(x, (QuantizedWeight, QuantizedWeight4)),
    )
    deq = transformer_forward(deq_tree, tokens, cfg)
    scale = float(jnp.max(jnp.abs(full)))
    assert float(jnp.max(jnp.abs(quant - deq))) < 0.03 * scale
    # ... while int4's inherent quantization error only gets a loose
    # sanity bound: with RANDOM-INIT weights the per-element absmax/7
    # rounding noise is large relative to the near-zero logit scale
    # (max rel err ~0.3 even at d_model=1024), so tightening this bound
    # would test init statistics, not the code. int4 weight quality on
    # trained checkpoints is an empirical, model-dependent question.
    assert float(jnp.max(jnp.abs(quant - full))) < 0.5 * scale


def test_engine_weight_quant_int4(lm):
    """weight_quant='int4' == manually bits=4-quantized params, token-exact."""
    from quantizedattention_tpu.serve import ServingEngine

    params, cfg = lm
    prompts = [[1, 2, 3, 4, 5], [7, 6, 5]]

    def run(p, **kw):
        eng = ServingEngine(p, cfg, n_slots=2, scheduler="python", **kw)
        rids = [eng.submit(x, 6) for x in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    assert run(params, weight_quant="int4") == run(quantize_lm_weights(params, bits=4))


def test_generate_with_quantized_weights(lm):
    params, cfg = lm
    qparams = quantize_lm_weights(params)
    prompt = jnp.array([[1, 2, 3, 4]], jnp.int32)
    out = generate(qparams, prompt, cfg, 6)
    assert out.shape == (1, 10)
    assert int(out.max()) < cfg.vocab_size and int(out.min()) >= 0


def test_engine_weight_quant(lm):
    """weight_quant='int8' == manually pre-quantized params, token-exact
    (same math, so the wiring — not the numerics — is under test); mesh +
    weight_quant rejects."""
    from quantizedattention_tpu.serve import ServingEngine

    params, cfg = lm
    prompts = [[1, 2, 3, 4, 5], [7, 6, 5]]

    def run(p, **kw):
        eng = ServingEngine(p, cfg, n_slots=2, scheduler="python", **kw)
        rids = [eng.submit(x, 6) for x in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    auto = run(params, weight_quant="int8")
    manual = run(quantize_lm_weights(params))
    assert auto == manual

    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(params, cfg, weight_quant="fp4")


def test_engine_weight_quant_mesh(lm):
    """Mesh serving with int8 weights: the sharded engine (QuantizedWeight
    leaves sharded by quantize_lm_specs — w_i8 on the weight's own spec,
    scale on its output axis) produces the same greedy tokens as the local
    int8-weights engine; int4 under a mesh rejects (packing not shardable
    along the contraction)."""
    from quantizedattention_tpu.parallel import make_attention_mesh
    from quantizedattention_tpu.serve import ServingEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    params, cfg = lm
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[1, 2, 3, 4, 5], [7, 6, 5], [2, 2], [9]]

    def run(**kw):
        eng = ServingEngine(params, cfg, n_slots=4, scheduler="python",
                            weight_quant="int8", **kw)
        rids = [eng.submit(x, 6) for x in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    assert run(mesh=mesh) == run()

    with pytest.raises(ValueError, match="int4"):
        ServingEngine(params, cfg, mesh=mesh, weight_quant="int4")
