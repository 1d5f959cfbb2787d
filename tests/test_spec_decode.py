"""Speculative decoding: the staircase verify, the verify step's
greedy acceptance rule, the n-gram proposer, and engine token-exactness.

No reference counterpart (the reference has no serving layer, SURVEY.md
§1). The load-bearing property throughout: GREEDY spec decode is
token-exact with plain greedy decode BY CONSTRUCTION — drafts only ever
get accepted when they equal the model's own argmax — so every test
compares against the plain path, not against golden values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.models import (
    TransformerConfig,
    decode_step_batched,
    init_transformer,
    prefill_batched,
    verify_step_batched,
)
from quantizedattention_tpu.parallel.kv_cache import (
    append_kv,
    decode_attention,
    init_kv_cache,
    verify_decode_attention,
)
from quantizedattention_tpu.serve import ServingEngine
from quantizedattention_tpu.serve.spec import propose_lookup


# -- proposer ----------------------------------------------------------------

def test_propose_lookup_basic():
    # trailing [7, 8] occurred earlier; continuation is [9, 1, 2]
    hist = [7, 8, 9, 1, 2, 5, 7, 8]
    assert propose_lookup(hist, 3) == [9, 1, 2]
    # truncated to k
    assert propose_lookup(hist, 2) == [9, 1]
    # no match at any n-gram length -> []
    assert propose_lookup([1, 2, 3, 4], 3) == []
    # most recent match wins: the SECOND [4, 5] is followed by 6
    hist = [4, 5, 9, 4, 5, 6, 0, 4, 5]
    assert propose_lookup(hist, 1) == [6]
    # periodic text extends itself (overlapping match)
    assert propose_lookup([1, 2, 1, 2, 1, 2], 2) == [1, 2]
    assert propose_lookup([], 3) == []


# -- staircase verify ---------------------------------------------------------

@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (4, 2), (8, 1)])
def test_verify_attention_matches_per_position(n_heads, n_kv):
    """verify_decode_attention row j == decode_attention with the cache
    truncated to that row's causal bound — per slot, head layout, and
    varied per-row lengths."""
    b, s, d, max_len = 3, 4, 64, 256
    key = jax.random.key(0)
    cache = init_kv_cache(b, n_kv, max_len, d)
    lengths = jnp.array([17, 50, 1], jnp.int32)
    # fill each row to its length with random K/V, then append s more
    kv = jax.random.normal(key, (2, b, n_kv, 64, d), jnp.float32)
    cache = append_kv(cache, kv[0], kv[1])
    cache = cache._replace(length=lengths)
    kv2 = jax.random.normal(jax.random.key(1), (2, b, n_kv, s, d), jnp.float32)
    cache = append_kv(cache, kv2[0], kv2[1])  # lengths now L_i + s

    q = jax.random.normal(jax.random.key(2), (b, n_heads, s, d), jnp.float32)
    got = verify_decode_attention(q, cache)
    assert got.shape == (b, n_heads, s, d)
    for j in range(s):
        want = decode_attention(
            q[:, :, j, :], cache._replace(length=lengths + j + 1)
        )
        np.testing.assert_allclose(
            np.asarray(got[:, :, j, :]), np.asarray(want), rtol=1e-5, atol=1e-5
        )


# -- verify step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = TransformerConfig(
        vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        n_layers=2, max_seq=128, attention="bf16",
    )
    return init_transformer(jax.random.key(3), cfg), cfg


def _plain_greedy(params, cfg, caches, last_tok, pos, active, n):
    toks = []
    for _ in range(n):
        last_tok, caches = decode_step_batched(
            params, caches, last_tok, pos, active, cfg
        )
        pos = pos + active.astype(jnp.int32)
        toks.append(last_tok)
    return jnp.stack(toks, 1), caches, last_tok, pos  # [b, n]


def test_verify_step_accepts_true_continuation(lm):
    """Feeding the model's own greedy continuation as the draft accepts
    everything: n_emit = s, and emitted == the plain greedy stream."""
    params, cfg = lm
    b, s = 2, 4
    prompt = jnp.array([[1, 2, 3, 4, 5, 6, 7, 8]] * b, jnp.int32)
    caches = [init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
              for _ in params["layers"]]
    first, caches = prefill_batched(params, caches, prompt, cfg)
    pos = jnp.full((b,), prompt.shape[1], jnp.int32)
    active = jnp.ones((b,), bool)

    stream, _, _, _ = _plain_greedy(params, cfg, caches, first, pos, active, s)
    draft = stream[:, : s - 1]  # the true continuation after `first`
    emitted, n_emit, vcaches = verify_step_batched(
        params, caches, first, draft, pos, active, cfg
    )
    np.testing.assert_array_equal(np.asarray(n_emit), s)
    np.testing.assert_array_equal(np.asarray(emitted), np.asarray(stream))
    # cache lengths advanced by the full s (nothing rolled back)
    np.testing.assert_array_equal(
        np.asarray(vcaches[0].length), np.asarray(pos + s)
    )


def test_verify_step_rejects_garbage_draft(lm):
    """A garbage draft emits exactly 1 token — the same token plain decode
    produces — and rolls the cache back to one appended entry."""
    params, cfg = lm
    b, s = 2, 4
    prompt = jnp.array([[9, 8, 7, 6], [3, 3, 3, 3]], jnp.int32)
    caches = [init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
              for _ in params["layers"]]
    first, caches = prefill_batched(params, caches, prompt, cfg)
    pos = jnp.full((b,), prompt.shape[1], jnp.int32)
    active = jnp.ones((b,), bool)

    plain_tok, _ = decode_step_batched(params, caches, first, pos, active, cfg)
    # draft tokens the greedy model will NOT pick (shift the plain token)
    draft = jnp.broadcast_to(
        ((plain_tok + 7) % cfg.vocab_size)[:, None], (b, s - 1)
    ).astype(jnp.int32)
    emitted, n_emit, vcaches = verify_step_batched(
        params, caches, first, draft, pos, active, cfg
    )
    np.testing.assert_array_equal(np.asarray(n_emit), 1)
    np.testing.assert_array_equal(np.asarray(emitted[:, 0]), np.asarray(plain_tok))
    np.testing.assert_array_equal(
        np.asarray(vcaches[0].length), np.asarray(pos + 1)
    )


def test_verify_step_inactive_rows_hold(lm):
    """Inactive slots never advance cache length or produce recordable
    state changes."""
    params, cfg = lm
    b, s = 2, 3
    prompt = jnp.array([[1, 2, 3, 4]] * b, jnp.int32)
    caches = [init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
              for _ in params["layers"]]
    first, caches = prefill_batched(params, caches, prompt, cfg)
    pos = jnp.full((b,), prompt.shape[1], jnp.int32)
    active = jnp.array([True, False])
    draft = jnp.zeros((b, s - 1), jnp.int32)
    _, _, vcaches = verify_step_batched(
        params, caches, first, draft, pos, active, cfg
    )
    lens = np.asarray(vcaches[0].length)
    assert lens[1] == prompt.shape[1]  # inactive: unchanged
    assert lens[0] >= prompt.shape[1] + 1


# -- engine end-to-end -----------------------------------------------------------

def _run_engine(params, cfg, prompts, budget=24, **kw):
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python", **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    res = eng.run()
    return [res[r].tokens for r in rids], eng


def test_engine_spec_token_exact(lm):
    """spec_decode engines produce byte-identical streams to the plain
    engine — with n-gram-friendly (periodic) AND unfriendly prompts — and
    the periodic prompt actually banks accepted drafts."""
    params, cfg = lm
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2, 47]]
    plain, _ = _run_engine(params, cfg, prompts)
    spec, eng = _run_engine(params, cfg, prompts, spec_decode=3)
    assert spec == plain
    st = eng.stats()["spec"]
    # recorded tokens = 1 prefill token per request + spec emissions
    # (st["emitted"] may exceed the recorded count by budget-surplus tokens
    # discarded at record time)
    assert st["emitted"] >= sum(len(t) for t in spec) - len(spec)
    # the periodic prompt must actually bank accepted drafts
    assert st["accepted"] > 0 and st["tokens_per_pass"] > 1.0


def test_paged_multi_token_append_and_staircase():
    """append_tokens_paged spanning a page boundary == token-at-a-time
    appends (same pages, offsets, scales); paged_verify_attention row j ==
    paged_decode_attention at that row's causal bound, on a shuffled page
    table."""
    from quantizedattention_tpu.parallel.paged_cache import (
        append_token_paged,
        append_tokens_paged,
        assign_pages,
        init_paged_cache,
        paged_decode_attention,
        paged_verify_attention,
    )

    hkv, d, ps = 2, 64, 128
    cache_a = init_paged_cache(hkv, n_pages=8, n_seqs=2, max_pages_per_seq=3,
                               head_dim=d, page_size=ps)
    cache_b = cache_a
    # shuffled, disjoint page lists per sequence
    cache_a = assign_pages(cache_a, jnp.int32(0), jnp.array([5, 2, 7]))
    cache_a = assign_pages(cache_a, jnp.int32(1), jnp.array([1, 6, 3]))
    cache_b = assign_pages(cache_b, jnp.int32(0), jnp.array([5, 2, 7]))
    cache_b = assign_pages(cache_b, jnp.int32(1), jnp.array([1, 6, 3]))
    # place both rows just short of a page boundary, then append 5 tokens
    base = jax.random.normal(jax.random.key(0), (2, 2, hkv, 126, d))
    act = jnp.ones((2,), bool)
    cache_a = append_tokens_paged(cache_a, base[0], base[1], act)
    cache_b = append_tokens_paged(cache_b, base[0], base[1], act)
    s = 5
    kv = jax.random.normal(jax.random.key(1), (2, 2, hkv, s, d))
    bulk = append_tokens_paged(cache_a, kv[0], kv[1], act)
    inc = cache_b
    for t in range(s):
        inc = append_token_paged(inc, kv[0][:, :, t:t+1], kv[1][:, :, t:t+1], act)
    np.testing.assert_array_equal(np.asarray(bulk.k_pages), np.asarray(inc.k_pages))
    np.testing.assert_array_equal(np.asarray(bulk.sv), np.asarray(inc.sv))
    assert bulk.lengths.tolist() == inc.lengths.tolist() == [131, 131]

    q = jax.random.normal(jax.random.key(2), (2, 4, s, d))
    got = paged_verify_attention(q, bulk)
    for j in range(s):
        want = paged_decode_attention(
            q[:, :, j, :], bulk._replace(lengths=jnp.full((2,), 126 + j + 1, jnp.int32))
        )
        np.testing.assert_allclose(
            np.asarray(got[:, :, j, :]), np.asarray(want), rtol=1e-5, atol=1e-5
        )


def test_engine_spec_paged_token_exact(lm):
    """spec_decode over the PAGED cache == plain paged engine, including
    composed with prefix caching (the tail-prefill + spec decode combo)."""
    params, cfg = lm
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2, 47]]
    kw = dict(cache="paged", n_pages=16, page_size=128)
    plain, _ = _run_engine(params, cfg, prompts, **kw)
    spec, eng = _run_engine(params, cfg, prompts, spec_decode=3, **kw)
    assert spec == plain
    assert eng.stats()["spec"]["accepted"] > 0

    kw2 = dict(kw, prefill_chunk=128, prefix_cache=True)
    plain2, _ = _run_engine(params, cfg, prompts, **kw2)
    spec2, _ = _run_engine(params, cfg, prompts, spec_decode=3, **kw2)
    assert spec2 == plain2


def test_engine_spec_eos_and_validation(lm):
    params, cfg = lm
    # EOS: pick the first generated token of a plain run as eos_id -> the
    # spec engine must stop at the same place
    prompts = [[4, 4, 5, 4, 4, 5, 4, 4]]
    plain, _ = _run_engine(params, cfg, prompts, budget=16)
    eos = plain[0][5]
    plain_eos, _ = _run_engine(params, cfg, prompts, budget=16, eos_id=eos)
    spec_eos, _ = _run_engine(params, cfg, prompts, budget=16, eos_id=eos,
                              spec_decode=4)
    assert spec_eos == plain_eos

    with pytest.raises(ValueError, match="horizon"):
        ServingEngine(params, cfg, decode_horizon=4, spec_decode=2)
    with pytest.raises(ValueError, match="spec_decode"):
        ServingEngine(params, cfg, spec_decode=0)


def test_native_proposer_matches_python():
    """native/ngram.cpp == the Python proposer on random, periodic, and
    edge-case histories (the differential-oracle pattern every native
    component here follows)."""
    import random as _random

    from quantizedattention_tpu.serve.spec import make_lookup, propose_lookup_native

    try:
        propose_lookup_native([1, 2, 1], 2)
    except Exception:
        pytest.skip("g++ unavailable")

    rng = _random.Random(0)
    cases = [[], [3], [1, 2, 1, 2, 1, 2], [7, 8, 9, 1, 2, 5, 7, 8],
             list(range(50))]
    for _ in range(200):
        n = rng.randrange(0, 60)
        vocab = rng.choice([2, 3, 8, 50])
        cases.append([rng.randrange(vocab) for _ in range(n)])
    for hist in cases:
        for k in (1, 3, 8):
            for mx in (1, 2, 3, 5):
                assert propose_lookup_native(hist, k, max_ngram=mx) == \
                    propose_lookup(hist, k, max_ngram=mx), (hist, k, mx)
    # make_lookup returns the native one when available
    assert make_lookup(prefer_native=True) is propose_lookup_native


# -- sampled (rejection-sampling) spec decode --------------------------------

def _sampled_draftfree_stream(params, cfg, caches, last_tok, pos, active,
                              n, key, temperature):
    """The sampling oracle: a draft-free verify loop (s_draft = 0) under
    `key`. Each call draws the next token from the verify distribution with
    the (slot, position)-keyed stream — exactly plain sampling, expressed
    through the same code path spec decode uses."""
    toks = []
    empty = jnp.zeros((last_tok.shape[0], 0), jnp.int32)
    for _ in range(n):
        emitted, n_emit, caches = verify_step_batched(
            params, caches, last_tok, empty, pos, active, cfg,
            temperature=temperature, key=key,
        )
        assert int(jnp.min(n_emit)) == 1
        last_tok = emitted[:, 0]
        pos = pos + active.astype(jnp.int32)
        toks.append(last_tok)
    return jnp.stack(toks, 1), caches, last_tok, pos


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_verify_step_sampled_realization_exact(lm, temperature):
    """SAMPLED spec decode is REALIZATION-equal (not just equal in law) to
    the draft-free sampled loop under the same base key: draws are keyed
    per (slot, absolute position), so 'sample from the verify distribution,
    accept while it equals the draft' replays the identical stream whatever
    the drafts are — all-accepted (drafts = the oracle's own future tokens)
    and all-rejected (garbage drafts) alike."""
    params, cfg = lm
    b, s, n = 2, 4, 8
    key = jax.random.key(42)
    prompt = jnp.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]],
                       jnp.int32)

    def fresh():
        caches = [init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
                  for _ in params["layers"]]
        first, caches = prefill_batched(params, caches, prompt, cfg)
        pos = jnp.full((b,), prompt.shape[1], jnp.int32)
        return caches, first, pos

    active = jnp.ones((b,), bool)
    caches, first, pos = fresh()
    oracle, _, _, _ = _sampled_draftfree_stream(
        params, cfg, caches, first, pos, active, n, key, temperature)

    def run_spec(make_draft):
        caches, last, p = fresh()
        got = [[] for _ in range(b)]
        while min(len(g) for g in got) < n:
            draft = make_draft(got)
            emitted, n_emit, caches = verify_step_batched(
                params, caches, last, draft, p, active, cfg,
                temperature=temperature, key=key,
            )
            for i in range(b):
                got[i].extend(int(t) for t in emitted[i, : int(n_emit[i])])
            last = emitted[jnp.arange(b), n_emit - 1]
            p = p + n_emit
        return [g[:n] for g in got]

    want = [[int(t) for t in oracle[i]] for i in range(b)]

    # all-accept path: feed the oracle's own future tokens as drafts
    def oracle_draft(got):
        return jnp.stack([
            jnp.asarray((want[i] + [0] * s)[len(got[i]):len(got[i]) + s - 1],
                        jnp.int32)
            for i in range(b)
        ])

    assert run_spec(oracle_draft) == want

    # all-reject path: drafts the sampler will (almost surely) not draw —
    # shift the oracle token by half the vocab
    def garbage_draft(got):
        base = oracle_draft(got)
        return (base + cfg.vocab_size // 2) % cfg.vocab_size

    assert run_spec(garbage_draft) == want


def test_engine_spec_sampling_reproducible_and_banks(lm):
    """Engine-level spec decode composed with temperature + top-k/top-p:
    same seed -> identical streams (with and WITHOUT spec: the per-dispatch
    key schedules differ, so cross-path equality is not expected — the
    verify-level realization test covers exactness), different seed ->
    different stream; periodic prompts still bank accepted drafts."""
    params, cfg = lm
    prompts = [[5, 6, 7] * 8, [12, 33, 2, 47]]
    kw = dict(temperature=0.8, top_k=8, top_p=0.95, seed=7)
    a, eng = _run_engine(params, cfg, prompts, spec_decode=3, **kw)
    b_, _ = _run_engine(params, cfg, prompts, spec_decode=3, **kw)
    assert a == b_
    assert all(0 <= t < cfg.vocab_size for seq in a for t in seq)
    c, _ = _run_engine(params, cfg, prompts, spec_decode=3,
                       **dict(kw, seed=8))
    assert c != a
    # low temperature concentrates mass on the mode -> periodic drafts
    # still get accepted through the sampled acceptance rule
    lowt, eng2 = _run_engine(params, cfg, [prompts[0]], spec_decode=3,
                             temperature=0.2, seed=7)
    assert eng2.stats()["spec"]["accepted"] > 0


# -- mesh x spec ---------------------------------------------------------------

@pytest.mark.parametrize("cache", ["slotted", "paged", "slotted-int4",
                                   "paged-int4", "slotted-w8"])
def test_engine_mesh_spec_token_exact(lm, cache):
    """spec_decode under MESH serving (round-4 verdict #7b lifted): the
    sharded verify step (slots on data, heads on model — the staircase
    kernel is per-(slot, kv-head), so zero extra collectives) must be
    token-exact with BOTH the plain mesh engine and the single-host spec
    engine, and must actually bank accepted drafts. The int4 arm runs the
    full matrix cell mesh x spec x packed-nibble staircase verify."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    import dataclasses as _dc

    from quantizedattention_tpu.parallel import make_attention_mesh

    params, cfg = lm
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[5, 6, 7] * 4, [12, 33, 2, 47], [9, 9, 2, 9, 9, 2, 9, 9], [4, 1]]
    kw = {}
    if cache == "paged":
        kw = dict(cache="paged", n_pages=16, page_size=128)
    elif cache == "slotted-int4":
        kw = dict(kv_quant="int4")
        cfg = _dc.replace(cfg, max_seq=256)  # int4 wants a 256-aligned max_seq
    elif cache == "paged-int4":
        kw = dict(cache="paged", n_pages=16, page_size=128, kv_quant="int4")
    elif cache == "slotted-w8":  # quantized-WEIGHT trees through the
        kw = dict(weight_quant="int8")  # sharded verify's mm dispatch

    def run(**extra):
        eng = ServingEngine(params, cfg, n_slots=4, scheduler="python",
                            **kw, **extra)
        rids = [eng.submit(p, 12) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids], eng

    plain_mesh, _ = run(mesh=mesh)
    spec_mesh, eng = run(mesh=mesh, spec_decode=3)
    assert eng.stats()["spec"]["accepted"] > 0
    if cache == "slotted-w8":
        # With QUANTIZED weights, spec-vs-plain exactness is only
        # approximate: the verify pass batches s positions through the
        # int8-dequant matmuls, whose f32 accumulation order can differ
        # from the s=1 decode pass in low bits — near-tie argmaxes flip
        # (the same class as the documented generate-vs-engine tie-flip
        # caveat). Assert the guaranteed properties instead: determinism
        # (same config twice -> identical streams) and stream validity.
        spec_mesh2, _ = run(mesh=mesh, spec_decode=3)
        assert spec_mesh == spec_mesh2
        assert all(0 <= t < cfg.vocab_size for s_ in spec_mesh for t in s_)
        assert all(len(s_) == 12 for s_ in spec_mesh)
        return
    assert spec_mesh == plain_mesh
    spec_local, _ = run(spec_decode=3)
    assert spec_mesh == spec_local


def test_engine_mesh_spec_sampling_reproducible(lm):
    """mesh x spec x sampling: same seed -> same streams, tokens in vocab."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    from quantizedattention_tpu.parallel import make_attention_mesh

    params, cfg = lm
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[5, 6, 7] * 4, [12, 33, 2, 47]]

    def run(seed):
        eng = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                            mesh=mesh, spec_decode=2, temperature=0.8,
                            top_k=8, seed=seed)
        rids = [eng.submit(p, 10) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids]

    a, b = run(3), run(3)
    assert a == b
    assert all(0 <= t < cfg.vocab_size for seq in a for t in seq)
    assert run(4) != a


@pytest.mark.parametrize("kvq", [None, "int4"])
def test_engine_spec_at_full_capacity(lm, kvq):
    """A slot whose prompt+budget EXACTLY fills max_seq must stay token-
    exact under spec decode: the verify step transiently appends spec+1
    tokens past max_seq, and the slotted int8 append would CLAMP (shifting
    the write onto live entries) without the engine's reserved slack rows.
    Regression for the round-4 review's top finding."""
    import dataclasses as _dc

    params, cfg = lm
    if kvq == "int4":  # the int4 cache wants a 256-aligned max_seq
        cfg = _dc.replace(cfg, max_seq=256)
    budget = 24
    prompt = ([5, 6, 7] * cfg.max_seq)[: cfg.max_seq - budget]
    assert len(prompt) + budget == cfg.max_seq
    kw = {} if kvq is None else {"kv_quant": kvq}
    plain, _ = _run_engine(params, cfg, [prompt], budget=budget, **kw)
    spec, _ = _run_engine(params, cfg, [prompt], budget=budget,
                          spec_decode=4, **kw)
    assert spec == plain and len(plain[0]) == budget
