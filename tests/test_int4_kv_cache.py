"""int4 KV cache: pack-block layout, append/install writers, the nibble
decode vs the oracle on its own dequantized view, the staircase
verify variant, and engine wiring (kv_quant='int4').

The kernel-correctness pattern mirrors the int8 cache tests
(tests/test_kv_cache.py) and the weight-int4 tests: compare against
reference_attention over dequantize_kv4's view, so nibble-rounding
(inherent, bounded by scale/2 per element) never hides a kernel bug.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.models import TransformerConfig, init_transformer
from quantizedattention_tpu.parallel import (
    append_kv4,
    decode_attention_int4,
    dequantize_kv4,
    init_kv4_cache,
    verify_decode_attention_int4,
    write_kv4_slot,
)
from quantizedattention_tpu.reference import reference_attention
from quantizedattention_tpu.serve import ServingEngine
from quantizedattention_tpu.utils.testing import mismatch_report


def test_append_roundtrip_and_lengths(rng):
    """Appends crossing pack-block boundaries dequantize back within the
    int4 step (scale/2 per element); lengths advance; tails stay zero."""
    cache = init_kv4_cache(batch=2, n_kv_heads=2, max_len=512, head_dim=64)
    k1, k2 = jax.random.split(rng)
    k_new = jax.random.normal(k1, (2, 2, 300, 64))  # > 256: crosses blocks
    v_new = jax.random.normal(k2, (2, 2, 300, 64))
    cache = append_kv4(cache, k_new, v_new)
    assert cache.length.tolist() == [300, 300]
    k_hat, v_hat = dequantize_kv4(cache)
    # per-token absmax/7 scale bound
    sk = jnp.maximum(jnp.max(jnp.abs(k_new), axis=-1), 1e-12) / 7.0
    err = jnp.abs(k_hat[:, :, :300] - k_new) / sk[..., None]
    assert float(jnp.max(err)) <= 0.5 + 1e-3
    assert float(jnp.abs(k_hat[:, :, 300:]).max()) == 0.0
    sv = jnp.maximum(jnp.max(jnp.abs(v_new), axis=-1), 1e-12) / 7.0
    assert float(jnp.max(jnp.abs(v_hat[:, :, :300] - v_new) / sv[..., None])) <= 0.5 + 1e-3


def test_incremental_append_matches_bulk(rng):
    """Token-at-a-time appends (the decode path's RMW nibble writes) build
    byte-identical state to one bulk append."""
    k1, k2 = jax.random.split(rng)
    k_all = jax.random.normal(k1, (1, 2, 20, 64))
    v_all = jax.random.normal(k2, (1, 2, 20, 64))
    bulk = append_kv4(init_kv4_cache(1, 2, 256, 64), k_all, v_all)
    inc = init_kv4_cache(1, 2, 256, 64)
    for t in range(20):
        inc = append_kv4(inc, k_all[:, :, t : t + 1], v_all[:, :, t : t + 1])
    np.testing.assert_array_equal(np.asarray(bulk.k_p), np.asarray(inc.k_p))
    np.testing.assert_array_equal(np.asarray(bulk.v_p), np.asarray(inc.v_p))
    np.testing.assert_array_equal(np.asarray(bulk.sk), np.asarray(inc.sk))
    assert bulk.length.tolist() == inc.length.tolist()


def test_write_slot_matches_append(rng):
    """write_kv4_slot (arithmetic packing, no RMW) == appends into a fresh
    row, on the dequantized view AND the packed bytes."""
    k1, k2 = jax.random.split(rng)
    k_new = jax.random.normal(k1, (2, 130, 64))  # ragged: not a PACK multiple
    v_new = jax.random.normal(k2, (2, 130, 64))
    a = append_kv4(init_kv4_cache(1, 2, 256, 64), k_new[None], v_new[None])
    w = write_kv4_slot(
        init_kv4_cache(1, 2, 256, 64), jnp.int32(0), k_new, v_new, jnp.int32(130)
    )
    # packed bytes must agree EXACTLY; scales only to the ULP (append_kv4
    # is jitted — XLA fuses the absmax/divide — while write_kv4_slot runs
    # eagerly, so the f32 scale can differ in the last bit)
    np.testing.assert_array_equal(np.asarray(a.k_p), np.asarray(w.k_p))
    np.testing.assert_array_equal(np.asarray(a.v_p), np.asarray(w.v_p))
    np.testing.assert_allclose(
        np.asarray(a.sk[:, :, :130]), np.asarray(w.sk[:, :, :130]), rtol=1e-6
    )
    assert w.length.tolist() == [130]


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 1)])
def test_decode_matches_oracle_on_dequantized(rng, hq, hkv):
    """Kernel == reference attention over the cache's own dequantized K/V —
    isolates kernel error (bf16 dots) from nibble rounding."""
    b, t, d = 2, 300, 64
    kk, kv_, kq = jax.random.split(rng, 3)
    k = jax.random.normal(kk, (b, hkv, t, d))
    v = jax.random.normal(kv_, (b, hkv, t, d))
    q1 = jax.random.normal(kq, (b, hq, d))

    cache = append_kv4(init_kv4_cache(b, hkv, 512, d), k, v)
    o = decode_attention_int4(q1, cache)
    assert o.shape == (b, hq, d)

    k_f, v_f = dequantize_kv4(cache)
    group = hq // hkv
    k_full = jnp.repeat(k_f[:, :, :t], group, axis=1)
    v_full = jnp.repeat(v_f[:, :, :t], group, axis=1)
    want = reference_attention(q1[:, :, None, :], k_full, v_full)[:, :, 0, :]
    rep = mismatch_report("decode4", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep


def test_decode_respects_length(rng):
    """Junk bytes past `length` must not leak into the softmax."""
    b, hq, hkv, d = 1, 2, 2, 64
    kk, kv_, kq = jax.random.split(rng, 3)
    k = jax.random.normal(kk, (b, hkv, 64, d))
    v = jax.random.normal(kv_, (b, hkv, 64, d))
    q1 = jax.random.normal(kq, (b, hq, d))
    cache_a = append_kv4(init_kv4_cache(b, hkv, 256, d), k, v)
    cache_b = cache_a._replace(
        k_p=cache_a.k_p.at[:, :, 64:].set(0x77),
        sk=cache_a.sk.at[:, :, 64:].set(1.0),
        v_p=cache_a.v_p.at[:, :, 64:].set(0x33),
        sv=cache_a.sv.at[:, :, 64:].set(1.0),
    )
    # note: byte rows [64:] hold the HIGH nibbles of tokens 128..255 too —
    # but those are past length as well, so nothing may change
    o_a = decode_attention_int4(q1, cache_a)
    o_b = decode_attention_int4(q1, cache_b)
    assert bool(jnp.allclose(o_a, o_b, atol=1e-6))


def test_verify_staircase_matches_per_position(rng):
    """verify_decode_attention_int4 row j == decode_attention_int4 with the
    cache truncated to that row's causal bound."""
    b, s, d, hq, hkv = 2, 4, 64, 4, 2
    lengths = jnp.array([37, 201], jnp.int32)
    cache = init_kv4_cache(b, hkv, 512, d)
    kv = jax.random.normal(rng, (2, b, hkv, 256, d))
    cache = append_kv4(cache, kv[0], kv[1])
    cache = cache._replace(length=lengths)
    kv2 = jax.random.normal(jax.random.key(11), (2, b, hkv, s, d))
    cache = append_kv4(cache, kv2[0], kv2[1])

    q = jax.random.normal(jax.random.key(12), (b, hq, s, d))
    got = verify_decode_attention_int4(q, cache)
    for j in range(s):
        want = decode_attention_int4(
            q[:, :, j, :], cache._replace(length=lengths + j + 1)
        )
        np.testing.assert_allclose(
            np.asarray(got[:, :, j, :]), np.asarray(want), rtol=1e-5, atol=1e-5
        )


# -- engine wiring ------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = TransformerConfig(
        vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        n_layers=2, max_seq=256, attention="bf16",
    )
    return init_transformer(jax.random.key(5), cfg), cfg


def _run(params, cfg, prompts, budget=16, **kw):
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python", **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    res = eng.run()
    return [res[r].tokens for r in rids]


def test_engine_kv4(lm):
    """kv_quant='int4' serves end-to-end (single + horizon + spec paths);
    spec == plain is token-exact UNDER THE SAME quantization."""
    params, cfg = lm
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2]]
    plain = _run(params, cfg, prompts, kv_quant="int4")
    assert all(len(t) == 16 for t in plain)
    horizon = _run(params, cfg, prompts, kv_quant="int4", decode_horizon=4)
    assert horizon == plain
    spec = _run(params, cfg, prompts, kv_quant="int4", spec_decode=3)
    assert spec == plain


def test_engine_kv4_validation(lm):
    params, cfg = lm
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(params, cfg, kv_quant="int2")


def test_engine_kv4_long_ctx_warns(lm):
    """kv_quant='int4' at long max_seq warns that int4 KV is a capacity
    feature, not a throughput one (round-5 measured negative,
    ARCHITECTURE §4); short max_seq stays silent."""
    import dataclasses as _dc
    import warnings

    params, cfg = lm
    with pytest.warns(UserWarning, match="capacity"):
        ServingEngine(params, _dc.replace(cfg, max_seq=4096), kv_quant="int4")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServingEngine(params, cfg, kv_quant="int4")  # max_seq 256: no warning


def test_engine_kv4_chunked_prefill(lm):
    """Slotted int4 + chunked prefill (write_kv4_chunk RMW across nibble
    halves + read_prefix_kv4): multi-chunk admission == one-shot prefill,
    token-exact under the same quantization."""
    params, cfg = lm  # max_seq 256
    long_prompt = list(range(1, 200))  # 199 tokens -> 2 chunks of 128
    plain = _run(params, cfg, [long_prompt], budget=8, kv_quant="int4")
    chunked = _run(params, cfg, [long_prompt], budget=8, kv_quant="int4",
                   prefill_chunk=128)
    assert chunked == plain


def test_engine_kv4_mesh(lm):
    """Mesh serving over the int4 cache (slots on data, kv heads on model;
    the pack-block axis is the unsharded token axis) == the local int4
    engine, token-exact."""
    from quantizedattention_tpu.parallel import make_attention_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    params, cfg = lm
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[5, 6, 7, 5, 6], [12, 33, 2], [1, 1, 1, 1], [9, 4]]

    def run(**kw):
        eng = ServingEngine(params, cfg, n_slots=4, scheduler="python",
                            kv_quant="int4", **kw)
        rids = [eng.submit(p, 8) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    assert run(mesh=mesh) == run()


# -- paged int4 -----------------------------------------------------------------

def test_paged4_append_and_staircase():
    """Paged int4: boundary-spanning multi-token appends == token-at-a-time;
    staircase verify == per-position decode; prompt-write == appends on the
    prefix view. Shuffled page tables throughout."""
    from quantizedattention_tpu.parallel.paged4_cache import (
        append_tokens_paged4,
        assign_pages4,
        init_paged4_cache,
        paged4_decode_attention,
        paged4_verify_attention,
        read_prefix_paged4,
        write_prompt_paged4,
    )

    hkv, d, ps = 2, 64, 128
    mk = lambda: init_paged4_cache(hkv, n_pages=8, n_seqs=2,
                                   max_pages_per_seq=3, head_dim=d,
                                   page_size=ps)
    pages = [jnp.array([5, 2, 7]), jnp.array([1, 6, 3])]

    def with_pages(c):
        c = assign_pages4(c, jnp.int32(0), pages[0])
        return assign_pages4(c, jnp.int32(1), pages[1])

    act = jnp.ones((2,), bool)
    base = jax.random.normal(jax.random.key(0), (2, 2, hkv, 125, d))
    a = append_tokens_paged4(with_pages(mk()), base[0], base[1], act)
    b = append_tokens_paged4(with_pages(mk()), base[0], base[1], act)
    s = 6  # spans the 125 -> 128 page boundary AND the nibble half at 64
    kv = jax.random.normal(jax.random.key(1), (2, 2, hkv, s, d))
    bulk = append_tokens_paged4(a, kv[0], kv[1], act)
    inc = b
    for t in range(s):
        inc = append_tokens_paged4(inc, kv[0][:, :, t:t+1], kv[1][:, :, t:t+1], act)
    np.testing.assert_array_equal(np.asarray(bulk.k_p), np.asarray(inc.k_p))
    np.testing.assert_array_equal(np.asarray(bulk.sv), np.asarray(inc.sv))
    assert bulk.lengths.tolist() == [131, 131]

    q = jax.random.normal(jax.random.key(2), (2, 4, s, d))
    got = paged4_verify_attention(q, bulk)
    for j in range(s):
        want = paged4_decode_attention(
            q[:, :, j, :],
            bulk._replace(lengths=jnp.full((2,), 125 + j + 1, jnp.int32)),
        )
        np.testing.assert_allclose(
            np.asarray(got[:, :, j, :]), np.asarray(want), rtol=1e-5, atol=1e-5
        )

    # write_prompt (arithmetic pack) == appends (RMW) on the dequantized
    # prefix; padded region is masked by true_len
    t_pad = 256
    k_new = jax.random.normal(jax.random.key(3), (hkv, t_pad, d))
    v_new = jax.random.normal(jax.random.key(4), (hkv, t_pad, d))
    w = write_prompt_paged4(with_pages(mk()), jnp.int32(0), k_new, v_new,
                            jnp.int32(200))
    ap = append_tokens_paged4(with_pages(mk()), k_new[None], v_new[None],
                              jnp.ones((1,), bool)[:1])
    kw_, vw_ = read_prefix_paged4(w, jnp.int32(0), 256)
    ka_, va_ = read_prefix_paged4(ap, jnp.int32(0), 256)
    np.testing.assert_allclose(np.asarray(kw_), np.asarray(ka_), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vw_), np.asarray(va_), rtol=1e-6)


def test_engine_paged4(lm):
    """kv_quant='int4' + cache='paged' serves end-to-end and is token-exact
    with the SLOTTED int4 engine (same quantization, different layout) —
    including spec decode and chunked prefill + prefix caching."""
    params, cfg = lm
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2]]
    kw = dict(cache="paged", n_pages=16, page_size=128, kv_quant="int4")

    slotted4 = _run(params, cfg, prompts, kv_quant="int4")
    paged4 = _run(params, cfg, prompts, **kw)
    assert paged4 == slotted4
    spec4 = _run(params, cfg, prompts, spec_decode=3, **kw)
    assert spec4 == slotted4

    # chunked prefill + automatic prefix caching over int4 pages
    kw2 = dict(kw, prefill_chunk=128, prefix_cache=True)
    a = _run(params, cfg, [list(range(1, 50))], **kw2)
    b = _run(params, cfg, [list(range(1, 50))], **kw2)
    assert a == b


def test_engine_paged4_mesh(lm):
    """Mesh serving over int4 PAGES (private per-data-shard pools,
    paged4_cache_specs) == the local paged4 engine, token-exact — with
    chunked prefill in the mix."""
    from quantizedattention_tpu.parallel import make_attention_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    params, cfg = lm
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[5, 6, 7, 5, 6], [12, 33, 2], list(range(1, 40)), [9, 4]]

    def run(**kw):
        eng = ServingEngine(params, cfg, n_slots=4, scheduler="python",
                            cache="paged", n_pages=16, page_size=128,
                            kv_quant="int4", prefill_chunk=128, **kw)
        rids = [eng.submit(p, 8) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    assert run(mesh=mesh) == run()
