"""Serving layer: continuous batching, native scheduler, sharded decode.

Correctness anchors:
  * scheduler: the native C++ core must match the pure-Python twin
    action-for-action on randomized workloads (differential test);
  * engine: continuous-batching output for every request must equal the
    sequential `generate` path (same params, same greedy decoding) — slots
    joining/leaving mid-flight must not perturb other slots;
  * sharded decode: the multi-chip step (slots on data, heads on model)
    must produce the same tokens as the single-device engine step.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.models import (
    TransformerConfig,
    generate,
    init_transformer,
)
from quantizedattention_tpu.serve import (
    PyScheduler,
    ServingEngine,
    make_scheduler,
    make_sharded_decode_step,
)
from quantizedattention_tpu.serve.scheduler import DECODE, IDLE, PREFILL, NativeScheduler


def small_cfg(**kw):
    defaults = dict(
        vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64,
        n_layers=2, max_seq=128, attention="bf16",
    )
    defaults.update(kw)
    return TransformerConfig(**defaults)


# ---------------------------------------------------------------------------
# Scheduler: native vs Python twin
# ---------------------------------------------------------------------------

def _native_or_skip(n_slots, max_len):
    try:
        return NativeScheduler(n_slots, max_len)
    except Exception as e:  # no g++ in env
        pytest.skip(f"native scheduler unavailable: {e}")


def test_scheduler_basic_lifecycle():
    for sched in (PyScheduler(2, 64), _native_or_skip(2, 64)):
        assert sched.next_action()[0] == IDLE
        assert sched.submit(0, prompt_len=8, max_new_tokens=2)
        act, rid, slot = sched.next_action()
        assert (act, rid) == (PREFILL, 0) and slot in (0, 1)
        assert sched.num_active == 1
        assert not sched.report_token(slot, False)  # 1/2 tokens
        assert sched.next_action()[0] == DECODE
        assert sched.report_token(slot, False)  # budget reached -> finished
        assert sched.num_active == 0 and sched.num_completed == 1
        assert sched.next_action()[0] == IDLE


def test_scheduler_rejects_oversized():
    for sched in (PyScheduler(2, 32), _native_or_skip(2, 32)):
        assert not sched.submit(0, prompt_len=30, max_new_tokens=10)
        assert sched.submit(1, prompt_len=16, max_new_tokens=16)


def test_scheduler_eos_frees_slot_early():
    for sched in (PyScheduler(1, 64), _native_or_skip(1, 64)):
        assert sched.submit(7, 4, 50)
        _, rid, slot = sched.next_action()
        assert rid == 7
        assert sched.report_token(slot, True)  # EOS on first token
        assert sched.num_active == 0


def test_scheduler_native_matches_python_differential():
    """Randomized workload: identical action traces from both cores."""
    nat = _native_or_skip(3, 64)
    py = PyScheduler(3, 64)
    rng = random.Random(0)
    next_id = 0
    for _ in range(500):
        if rng.random() < 0.3:
            plen = rng.randint(1, 40)
            mnt = rng.randint(1, 40)
            assert nat.submit(next_id, plen, mnt) == py.submit(next_id, plen, mnt)
            next_id += 1
        a_n = nat.next_action()
        a_p = py.next_action()
        assert a_n == a_p, f"diverged: native={a_n} python={a_p}"
        act, _rid, slot = a_n
        if act == PREFILL:
            if rng.random() < 0.15:  # engine couldn't serve it (e.g. no pages)
                nat.requeue(slot)
                py.requeue(slot)
                continue
            assert nat.report_token(slot, False) == py.report_token(slot, False)
        elif act == DECODE:
            # report a token on every active slot, EOS with prob 0.1
            for s in range(3):
                if py.slot_request(s) >= 0:
                    assert nat.slot_request(s) == py.slot_request(s)
                    eos = rng.random() < 0.1
                    assert nat.report_token(s, eos) == py.report_token(s, eos)
        assert (nat.num_active, nat.num_waiting, nat.num_completed) == (
            py.num_active, py.num_waiting, py.num_completed,
        )


# ---------------------------------------------------------------------------
# Engine: continuous batching == sequential generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = small_cfg()
    params = init_transformer(jax.random.key(0), cfg)
    return params, cfg


def test_engine_single_request_matches_generate(lm):
    params, cfg = lm
    prompt = [3, 14, 15, 9, 2, 6]
    n_new = 6
    want = generate(params, jnp.asarray([prompt], jnp.int32), cfg, max_new_tokens=n_new)
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python")
    rid = eng.submit(prompt, max_new_tokens=n_new)
    results = eng.run()
    got = results[rid]
    assert got.finish_reason == "length"
    assert got.tokens == [int(t) for t in np.asarray(want[0, len(prompt):])]


def test_engine_continuous_batching_matches_sequential(lm):
    """More requests than slots, different lengths/budgets: every request's
    tokens must match its own single-request generate run."""
    params, cfg = lm
    prompts = [
        [1, 2, 3],
        [10, 20, 30, 40, 50, 60, 7],
        [5] * 12,
        [63, 0, 42, 17],
        [9, 8, 7, 6, 5, 4, 3, 2, 1],
    ]
    budgets = [4, 7, 3, 6, 5]
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="native")
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    results = eng.run()
    assert len(results) == len(prompts)
    for rid, p, b in zip(rids, prompts, budgets):
        want = generate(params, jnp.asarray([p], jnp.int32), cfg, max_new_tokens=b)
        want_tokens = [int(t) for t in np.asarray(want[0, len(p):])]
        assert results[rid].tokens == want_tokens, f"request {rid} diverged"


def test_engine_eos_stops_early(lm):
    params, cfg = lm
    prompt = [1, 2, 3, 4]
    # find what the model actually generates, then use its 2nd token as EOS
    ref = generate(params, jnp.asarray([prompt], jnp.int32), cfg, max_new_tokens=4)
    ref_tokens = [int(t) for t in np.asarray(ref[0, len(prompt):])]
    eos = ref_tokens[1]
    eng = ServingEngine(params, cfg, n_slots=1, eos_id=eos, scheduler="python")
    rid = eng.submit(prompt, max_new_tokens=10)
    res = eng.run()[rid]
    assert res.finish_reason == "eos"
    assert res.tokens == ref_tokens[: ref_tokens.index(eos) + 1]


def test_engine_rejects_oversized_request(lm):
    params, cfg = lm
    eng = ServingEngine(params, cfg, n_slots=1, scheduler="python")
    with pytest.raises(ValueError, match="rejected"):
        eng.submit(list(range(cfg.max_seq)), max_new_tokens=8)


def test_engine_late_submit_joins_running_batch(lm):
    """A request submitted while another is mid-decode joins without
    corrupting it (the core continuous-batching property)."""
    params, cfg = lm
    p1, p2 = [4, 8, 15, 16], [23, 42]
    b1, b2 = 8, 4
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python")
    r1 = eng.submit(p1, b1)
    for _ in range(3):  # prefill r1 + a couple of decode steps
        assert eng.step()
    r2 = eng.submit(p2, b2)
    results = eng.run()
    for rid, p, b in ((r1, p1, b1), (r2, p2, b2)):
        want = generate(params, jnp.asarray([p], jnp.int32), cfg, max_new_tokens=b)
        assert results[rid].tokens == [int(t) for t in np.asarray(want[0, len(p):])]


# ---------------------------------------------------------------------------
# Sharded decode step (slots on data, heads on model)
# ---------------------------------------------------------------------------

def test_sharded_decode_matches_local():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    from quantizedattention_tpu.parallel import make_attention_mesh
    from quantizedattention_tpu.serve.engine import serving_shardings

    cfg = small_cfg(n_heads=4, n_kv_heads=4)
    params = init_transformer(jax.random.key(1), cfg)
    mesh = make_attention_mesh(data=2, model=2, context=1)

    # boot engine state by prefilling two requests locally
    eng = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    eng.submit([1, 2, 3, 4, 5], 8)
    eng.submit([7, 6], 8)
    assert eng.step() and eng.step()  # two prefills

    from quantizedattention_tpu.models import decode_step_batched

    local_tok, local_caches = jax.jit(decode_step_batched, static_argnames="cfg")(
        params, eng.caches, eng.last_tok, eng.pos, eng.active, cfg
    )

    step = make_sharded_decode_step(mesh, cfg)
    pshard, cshard, vshard = serving_shardings(mesh, cfg)
    params_s = jax.device_put(params, pshard)
    caches_s = jax.device_put(eng.caches, cshard)
    lt = jax.device_put(eng.last_tok, vshard)
    po = jax.device_put(eng.pos, vshard)
    ac = jax.device_put(eng.active, vshard)
    shard_tok, shard_caches = step(params_s, caches_s, lt, po, ac)

    np.testing.assert_array_equal(np.asarray(local_tok), np.asarray(shard_tok))
    for lc, sc in zip(local_caches, shard_caches):
        np.testing.assert_array_equal(np.asarray(lc.length), np.asarray(sc.length))
        np.testing.assert_allclose(
            np.asarray(lc.k_i8, np.int32), np.asarray(sc.k_i8, np.int32), atol=1
        )


def test_engine_mesh_mode_matches_local():
    """Full continuous-batching run with mesh sharding (slots on data, heads
    on model) must produce the same greedy tokens as the local engine."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    from quantizedattention_tpu.parallel import make_attention_mesh

    cfg = small_cfg(n_heads=4, n_kv_heads=4)
    params = init_transformer(jax.random.key(2), cfg)
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4]]
    budgets = [5, 4, 6, 3]

    local = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    rids_l = [local.submit(p, b) for p, b in zip(prompts, budgets)]
    res_l = local.run()

    sharded = ServingEngine(params, cfg, n_slots=4, scheduler="python", mesh=mesh)
    rids_s = [sharded.submit(p, b) for p, b in zip(prompts, budgets)]
    res_s = sharded.run()

    for rl, rs in zip(rids_l, rids_s):
        assert res_l[rl].tokens == res_s[rs].tokens


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_engine_chunked_prefill_matches_unchunked(cache):
    """Chunked prefill (prefix read back from the quantized cache/pages)
    must produce the same greedy tokens as the one-shot prefill engine on
    these seeds, for single and concurrent requests."""
    cfg = small_cfg(max_seq=512)
    params = init_transformer(jax.random.key(0), cfg)
    long_prompt = [int(x) for x in range(2, 50)]  # 48 tokens, chunk=128 -> 1 chunk
    longer = ([7, 3, 9, 11] * 80)[: cfg.max_seq - 40]  # multi-chunk prompt

    plain = ServingEngine(params, cfg, n_slots=2, scheduler="python", cache=cache)
    r1 = plain.submit(longer, 8)
    r2 = plain.submit(long_prompt, 8)
    res_plain = plain.run()

    chunked = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                            cache=cache, prefill_chunk=128)
    c1 = chunked.submit(longer, 8)
    c2 = chunked.submit(long_prompt, 8)
    res_chunked = chunked.run()

    assert res_plain[r1].tokens == res_chunked[c1].tokens
    assert res_plain[r2].tokens == res_chunked[c2].tokens


def test_engine_chunked_prefill_nonaligned_capacity():
    """Code-review regression: last chunk overhangs a max_seq that is not a
    multiple of the chunk (384 vs 256) — the write must trim to capacity
    instead of letting dynamic_update_slice clamp the start and corrupt
    earlier positions."""
    cfg = small_cfg(max_seq=384)
    params = init_transformer(jax.random.key(0), cfg)
    prompt = [int(x % 63) + 1 for x in range(300)]

    plain = ServingEngine(params, cfg, n_slots=1, scheduler="python")
    r0 = plain.submit(prompt, 6)
    want = plain.run()[r0].tokens

    chunked = ServingEngine(params, cfg, n_slots=1, scheduler="python",
                            prefill_chunk=256)
    r1 = chunked.submit(prompt, 6)
    got = chunked.run()[r1].tokens
    assert got == want


def test_engine_chunked_prefill_interleaves_decodes():
    """A long prompt must NOT stall running decodes: with chunked prefill,
    the already-running request keeps emitting tokens between chunks (the
    round-1 verdict's prefill-XOR-decode stall)."""
    cfg = small_cfg(max_seq=512)
    params = init_transformer(jax.random.key(0), cfg)
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                        prefill_chunk=128)
    ra = eng.submit([5, 6, 7], 20)
    # admit A and decode a couple of tokens
    eng.step()
    eng.step()
    tokens_before = len(eng._outputs[ra])
    # submit the long prompt; drive until its first token lands
    long_prompt = ([1, 2, 3, 4] * 90)[: cfg.max_seq - 30]
    rb = eng.submit(long_prompt, 4)
    n_chunks = -(-len(long_prompt) // 128)
    assert n_chunks >= 2
    while rb not in eng._finished and not eng._outputs[rb]:
        assert eng.step()
    # A made progress while B was prefilling
    assert len(eng._outputs[ra]) > tokens_before
    res = eng.run()
    assert len(res[rb].tokens) == 4
    assert len(res[ra].tokens) == 20


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_engine_mesh_chunked_prefill_matches_local(cache):
    """Chunked prefill under a mesh (owner-masked prefix merge + psum
    selection): tokens must equal the local unchunked engine's."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    from quantizedattention_tpu.parallel import make_attention_mesh

    cfg = small_cfg(n_heads=4, n_kv_heads=4, max_seq=512)
    params = init_transformer(jax.random.key(2), cfg)
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [([3, 1, 4, 1, 5] * 70)[:330], [9, 8, 7], [5] * 200, [2, 4]]
    budgets = [5, 4, 6, 3]

    local = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    rids_l = [local.submit(p, b) for p, b in zip(prompts, budgets)]
    res_l = local.run()

    sharded = ServingEngine(params, cfg, n_slots=4, scheduler="python",
                            mesh=mesh, cache=cache, prefill_chunk=128,
                            decode_horizon=2 if cache == "paged" else 1)
    rids_s = [sharded.submit(p, b) for p, b in zip(prompts, budgets)]
    res_s = sharded.run()

    for rl, rs in zip(rids_l, rids_s):
        assert res_l[rl].tokens == res_s[rs].tokens


def test_engine_mesh_paged_horizon_matches_local():
    """Mesh + paged cache + decode horizon (round-1 verdict gap: both raised
    ValueError under a mesh): per-data-shard page pools, shard_map prefill,
    and a 4-step horizon bank must be token-exact vs the local slotted
    engine."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 emulated devices")
    from quantizedattention_tpu.parallel import make_attention_mesh

    cfg = small_cfg(n_heads=4, n_kv_heads=4)
    params = init_transformer(jax.random.key(2), cfg)
    mesh = make_attention_mesh(data=2, model=2, context=1)
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4]]
    budgets = [5, 4, 6, 3]

    local = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    rids_l = [local.submit(p, b) for p, b in zip(prompts, budgets)]
    res_l = local.run()

    sharded = ServingEngine(
        params, cfg, n_slots=4, scheduler="python", mesh=mesh,
        cache="paged", decode_horizon=4,
    )
    rids_s = [sharded.submit(p, b) for p, b in zip(prompts, budgets)]
    res_s = sharded.run()

    for rl, rs in zip(rids_l, rids_s):
        assert res_l[rl].tokens == res_s[rs].tokens
    stats = sharded.stats()
    assert stats["pages_free"] > 0 and stats["cache"] == "paged"


def test_engine_temperature_sampling(lm):
    """temperature > 0: tokens stay in-vocab, runs complete, and two seeds
    differ (overwhelmingly likely for 12 sampled tokens over vocab 64)."""
    params, cfg = lm
    outs = []
    for seed in (0, 1):
        eng = ServingEngine(
            params, cfg, n_slots=2, scheduler="python", temperature=1.0, seed=seed
        )
        rid = eng.submit([1, 2, 3], max_new_tokens=12)
        res = eng.run()[rid]
        assert len(res.tokens) == 12
        assert all(0 <= t < cfg.vocab_size for t in res.tokens)
        outs.append(res.tokens)
    assert outs[0] != outs[1]


def test_make_scheduler_fallback():
    s = make_scheduler(2, 64, prefer_native=False)
    assert isinstance(s, PyScheduler)


def test_engine_paged_matches_slotted(lm):
    """Paged continuous batching (C++/Python page allocator, page-table
    gather decode) produces the same greedy tokens as the slotted engine,
    across enough requests that pages are freed and reallocated."""
    params, cfg = lm
    prompts = [
        [1, 2, 3, 4, 5],
        [10, 20, 30],
        [7] * 20,
        [42, 17],
        [9, 8, 7, 6, 5, 4],
        [3] * 11,
    ]
    budgets = [6, 4, 8, 5, 3, 7]

    slotted = ServingEngine(params, cfg, n_slots=2, scheduler="python")
    r1 = [slotted.submit(p, b) for p, b in zip(prompts, budgets)]
    res1 = slotted.run()

    # small pool (enough for 2 slots only) forces free->realloc churn
    paged = ServingEngine(
        params, cfg, n_slots=2, scheduler="python", cache="paged", page_size=128,
    )
    free0 = paged._pager.num_free
    r2 = [paged.submit(p, b) for p, b in zip(prompts, budgets)]
    res2 = paged.run()

    for a, b in zip(r1, r2):
        assert res1[a].tokens == res2[b].tokens
    assert paged._pager.num_free == free0  # every page returned to the pool


def test_engine_paged_pool_exhaustion_requeues(lm):
    """A prefill that can't get pages must NOT wedge the engine: the request
    requeues at the front and completes once earlier requests free pages."""
    params, cfg = lm  # max_seq 128, page_size 128 -> 1 page per request
    # pool with exactly ONE usable page: requests must run strictly serially
    eng = ServingEngine(
        params, cfg, n_slots=2, scheduler="python", cache="paged",
        page_size=128, n_pages=2,
    )
    rids = [eng.submit([1, 2, 3], 4), eng.submit([9, 8], 3)]
    results = eng.run()
    assert len(results) == 2
    for rid, p, b in zip(rids, [[1, 2, 3], [9, 8]], [4, 3]):
        want = generate(params, jnp.asarray([p], jnp.int32), cfg, max_new_tokens=b)
        assert results[rid].tokens == [int(t) for t in np.asarray(want[0, len(p):])]
    assert eng._pager.num_free == 1  # the single page returned


def test_engine_paged_rejects_request_larger_than_pool(lm):
    params, cfg = lm
    eng = ServingEngine(
        params, cfg, n_slots=1, scheduler="python", cache="paged",
        page_size=128, n_pages=2,
    )
    with pytest.raises(ValueError, match="pages"):
        # needs 2 pages (>128 tokens total) but the pool has 1 usable
        eng.submit(list(range(100)), max_new_tokens=60)


def test_pager_double_free_ignored():
    from quantizedattention_tpu.serve import PyPager
    from quantizedattention_tpu.serve.scheduler import NativePager

    pagers = [PyPager(4)]
    try:
        pagers.append(NativePager(4))
    except Exception:
        pass
    for p in pagers:
        got = p.alloc(1)
        p.free(got)
        p.free(got)  # double-free must be ignored, not alias the page
        assert p.num_free == 3
        a = p.alloc(3)
        assert sorted(a) == [1, 2, 3]  # no duplicates handed out


def test_engine_param_dtype_bf16(lm):
    """bf16 serving weights: engine completes and tokens stay in-vocab
    (numerics shift vs f32, so no exact-parity claim — perf option)."""
    params, cfg = lm
    eng = ServingEngine(
        params, cfg, n_slots=2, scheduler="python", param_dtype=jnp.bfloat16
    )
    rid = eng.submit([1, 2, 3, 4], max_new_tokens=6)
    res = eng.run()[rid]
    assert len(res.tokens) == 6
    assert all(0 <= t < cfg.vocab_size for t in res.tokens)


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_engine_decode_horizon_matches_single_step(lm, cache):
    """horizon=4 (4 chained decode steps per host fetch) must produce the
    same greedy tokens as horizon=1, including EOS/budget finishing
    mid-horizon and slot reuse afterwards."""
    params, cfg = lm
    prompts = [[1, 2, 3], [10, 20, 30, 40], [5] * 9, [62, 61]]
    budgets = [6, 5, 7, 3]  # deliberately NOT multiples of the horizon

    base = ServingEngine(params, cfg, n_slots=2, scheduler="python", cache=cache)
    r1 = [base.submit(p, b) for p, b in zip(prompts, budgets)]
    res1 = base.run()

    fast = ServingEngine(
        params, cfg, n_slots=2, scheduler="python", cache=cache, decode_horizon=4
    )
    r2 = [fast.submit(p, b) for p, b in zip(prompts, budgets)]
    res2 = fast.run()

    for a, b in zip(r1, r2):
        assert res1[a].tokens == res2[b].tokens
        assert res1[a].finish_reason == res2[b].finish_reason


def test_engine_decode_horizon_eos(lm):
    params, cfg = lm
    prompt = [1, 2, 3, 4]
    ref = generate(params, jnp.asarray([prompt], jnp.int32), cfg, max_new_tokens=6)
    ref_tokens = [int(t) for t in np.asarray(ref[0, len(prompt):])]
    eos = ref_tokens[2]  # EOS lands mid-horizon
    eng = ServingEngine(
        params, cfg, n_slots=1, eos_id=eos, scheduler="python", decode_horizon=4
    )
    rid = eng.submit(prompt, max_new_tokens=10)
    res = eng.run()[rid]
    assert res.finish_reason == "eos"
    assert res.tokens == ref_tokens[: ref_tokens.index(eos) + 1]


def test_engine_stats(lm):
    params, cfg = lm
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python", cache="paged")
    eng.submit([1, 2, 3], 4)
    eng.submit([5, 6], 3)
    s0 = eng.stats()
    assert s0["waiting"] == 2 and s0["active"] == 0 and s0["completed"] == 0
    eng.run()
    s1 = eng.stats()
    assert s1["completed"] == 2 and s1["active"] == 0
    assert s1["tokens_generated"] == 7
    assert s1["last_run_tokens_per_s"] > 0
    assert s1["pages_free"] == s0["pages_free"]  # all pages returned


def test_engine_soak_random_workload(lm):
    """Soak: 20 random requests through 3 slots. Oracle is CROSS-ENGINE
    parity — paged+horizon vs slotted horizon=1 under the same scheduler
    policy sees identical batch compositions, so tokens must be EXACT even
    on the real chip (engine-vs-generate would flake there on argmax
    tie-flips from differing batch composition; see the verify skill)."""
    params, cfg = lm
    rng = random.Random(3)
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(rng.randint(1, 30))]
               for _ in range(20)]
    budgets = [rng.randint(1, 12) for _ in range(20)]

    base = ServingEngine(params, cfg, n_slots=3, scheduler="python")
    r0 = [base.submit(p, b) for p, b in zip(prompts, budgets)]
    want = base.run()

    eng = ServingEngine(
        params, cfg, n_slots=3, scheduler="native", cache="paged",
        decode_horizon=3,
    )
    free0 = eng._pager.num_free
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    results = eng.run()
    assert len(results) == 20
    assert eng._pager.num_free == free0
    for a, b in zip(r0, rids):
        assert want[a].tokens == results[b].tokens, (a, b)


def test_engine_latency_metrics(lm):
    params, cfg = lm
    eng = ServingEngine(params, cfg, n_slots=1, scheduler="python")
    rid = eng.submit([1, 2, 3], 4)
    res = eng.run()[rid]
    assert res.ttft_s is not None and res.duration_s is not None
    assert 0 < res.ttft_s <= res.duration_s


def test_batched_admission_single_dispatch(rng):
    """Several waiting requests admit in ONE multi-slot prefill dispatch
    (each dispatch carries a fixed host cost), and tokens match sequential
    single-slot admission."""
    cfg = small_cfg()
    params = init_transformer(rng, cfg)
    prompts = [[1, 2, 3], [9, 8, 7, 6], [4] * 10, [11, 12]]

    eng = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    calls = {"batched": 0, "single": 0}
    orig = eng._dispatch_prefills

    def spy(batch):
        calls["batched" if len(batch) > 1 else "single"] += 1
        return orig(batch)

    eng._dispatch_prefills = spy
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    out = eng.run()
    assert calls["batched"] == 1 and calls["single"] == 0
    got = {r: out[r].tokens for r in rids}

    # sequential reference: one request at a time (no batching possible)
    eng2 = ServingEngine(params, cfg, n_slots=4, scheduler="python")
    want = {}
    for p, r in zip(prompts, rids):
        r2 = eng2.submit(p, max_new_tokens=5)
        want[r] = eng2.run()[r2].tokens
    assert got == want, (got, want)


def test_adaptive_horizon_token_parity(rng):
    """adaptive_horizon banks variable power-of-two bucket sizes; tokens
    must match the fixed-horizon engine exactly, and the bucket picks must
    shrink toward the remaining budget (no surplus-heavy full banks)."""
    cfg = small_cfg()
    params = init_transformer(rng, cfg)
    fixed = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                          decode_horizon=4)
    adapt = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                          decode_horizon=4, adaptive_horizon=32)
    picks = []
    orig = adapt._pick_horizon

    def spy(active):
        h = orig(active)
        picks.append(h)
        return h

    adapt._pick_horizon = spy
    want, got = {}, {}
    for eng, dst in ((fixed, want), (adapt, got)):
        r0 = eng.submit([1, 2, 3], max_new_tokens=13)
        r1 = eng.submit([4, 5], max_new_tokens=13)
        out = eng.run()
        dst.update({0: out[r0].tokens, 1: out[r1].tokens})
    assert got == want, (got, want)
    assert picks, "adaptive engine never decoded"
    assert all(h & (h - 1) == 0 for h in picks), picks  # powers of two
    # queue empty: ONE ceil-bucket bank covers the whole remaining budget
    # (12 remaining after the prefill token -> ceil_pow2 = 16)
    assert max(picks) == 16, picks
    assert len([h for h in picks if h > 1]) == 1, picks


def test_surplus_bank_guard(rng):
    """When the pending fetches already satisfy every slot's budget, the
    engine flushes instead of dispatching a provably-surplus decode bank."""
    cfg = small_cfg()
    params = init_transformer(rng, cfg)
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python",
                        decode_horizon=8)
    n_decodes = {"n": 0}
    orig = eng._horizon_fn

    def spy_fn(h):
        inner = orig(h)

        def spy(*a, **k):
            n_decodes["n"] += 1
            return inner(*a, **k)

        return spy

    eng._horizon_fn = spy_fn
    # budget 8 = exactly one bank after the prefill token: a second bank
    # would be 100% surplus and must not be dispatched
    r0 = eng.submit([1, 2, 3], max_new_tokens=9)
    r1 = eng.submit([4, 5], max_new_tokens=9)
    out = eng.run()
    assert n_decodes["n"] == 1, n_decodes
    assert len(out[r0].tokens) == 9 and len(out[r1].tokens) == 9


@pytest.mark.parametrize("kw", [{}, {"decode_horizon": 4}, {"spec_decode": 3}])
def test_streaming_on_token_callback(kw):
    """submit(on_token=...) streams exactly the result tokens, in order,
    with done=True only on the final one — across single-step, horizon-
    bank, and speculative engines (bursts per fetch are still per-token
    callbacks)."""
    cfg = small_cfg()
    params = init_transformer(jax.random.key(0), cfg)
    eng = ServingEngine(params, cfg, n_slots=2, scheduler="python", **kw)
    got = {0: [], 1: []}

    def cb(rid, tok, done):
        got[rid].append((tok, done))

    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2]]
    rids = [eng.submit(p, 10, on_token=cb) for p in prompts]
    res = eng.run()
    for i, rid in enumerate(rids):
        toks = [t for t, _ in got[i]]
        assert toks == res[rid].tokens
        assert [d for _, d in got[i]] == [False] * (len(toks) - 1) + [True]


def test_streaming_callback_eos():
    """done=True fires on the EOS token and nothing streams after it."""
    cfg = small_cfg()
    params = init_transformer(jax.random.key(0), cfg)
    probe = ServingEngine(params, cfg, n_slots=1, scheduler="python")
    r = probe.submit([4, 4, 5, 4], 12)
    eos = probe.run()[r].tokens[4]

    eng = ServingEngine(params, cfg, n_slots=1, scheduler="python", eos_id=eos)
    seen = []
    rid = eng.submit([4, 4, 5, 4], 12, on_token=lambda r_, t, d: seen.append((t, d)))
    res = eng.run()
    assert [t for t, _ in seen] == res[rid].tokens
    assert seen[-1] == (eos, True)
