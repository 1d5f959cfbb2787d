"""Continuous-batching serving engine on the int8 KV cache.

The compute half of the serving layer (the native C++ scheduler in
serve/scheduler.py is the policy half). The reference has no serving path
at all (SURVEY.md §1); the north-star (BASELINE.json) demands "head/KV
tensor-sharding over a multi-host mesh via shard_map with
quantized KV-cache, continuous batching across hosts".

Engine loop (classic continuous batching):
  * requests join a native FCFS queue (`submit`);
  * each `step` asks the scheduler for ONE action: admit a waiting request
    into a free cache slot via a fused prefill (the whole prompt through
    the causal flash kernel in one pass, prompt K/V quantized into the
    slot), or run ONE batched decode step across every active slot;
  * slots finish independently (EOS or budget) and free immediately, so a
    new request's prefill slides in between decode steps — the decode
    batch never drains to restart.

All decode work is one jitted step over the full slot batch: per-row RoPE
positions, length-masked int8 decode attention (parallel/kv_cache.py), and
an active mask so idle slots never advance. Prompts are right-padded to
power-of-two buckets so prefill compiles once per bucket.

Multi-host: `make_sharded_decode_step` shards slots over the mesh's `data`
axis and attention heads / MLP hidden over `model` (the same Megatron
layout as models/sharded_train.py), with the KV cache sharded on
(slots, kv-heads) — decode attention itself needs zero collectives; only
the out/down projections psum.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantizedattention_tpu.models.transformer import (
    Sampling,
    _cache_append,
    _cache_decode,
    _cache_write_slot,
    TransformerConfig,
    decode_horizon_batched,
    decode_step_batched,
    prefill_chunk as prefill_chunk_step,
    prefill_slot,
    prefill_slots,
    rmsnorm,
    rope,
    sampling_temperature,
    verify_step_batched,
)
from quantizedattention_tpu.quantize.weights import embedding_lookup, mm
from quantizedattention_tpu.serve.spec import make_lookup
from quantizedattention_tpu.parallel.kv_cache import (
    QuantizedKVCache,
    append_kv,
    decode_attention,
    init_kv_cache,
)
from quantizedattention_tpu.parallel.paged_cache import assign_pages, init_paged_cache
from quantizedattention_tpu.serve.scheduler import (
    DECODE,
    IDLE,
    PREFILL,
    make_pager,
    make_scheduler,
)
from quantizedattention_tpu.serve.prefix_store import make_prefix_store


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: list[int]
    tokens: list[int]          # generated tokens (includes EOS if hit)
    finish_reason: str         # "eos" | "length"
    ttft_s: float | None = None      # submit -> first token (time-to-first-token)
    duration_s: float | None = None  # submit -> completion


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ServingEngine:
    """Continuous-batching engine over `n_slots` KV-cache rows.

    params/cfg: a models.transformer LM. eos_id: optional stop token.
    scheduler: "native" (C++ via ctypes; falls back to the Python twin if
    g++ is unavailable) or "python".
    decode_horizon: fixed decode-bank size (K chained steps per dispatch,
    one token fetch per bank). adaptive_horizon: optional cap enabling
    per-dispatch bank sizing from remaining budgets (see _pick_horizon) —
    tokens are identical, dispatch/fetch cycles fewer.
    """

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        n_slots: int = 4,
        eos_id: int | None = None,
        scheduler: str = "native",
        mesh: Mesh | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        cache: str = "slotted",
        page_size: int = 128,
        n_pages: int | None = None,
        param_dtype=None,
        weight_quant: str | None = None,
        decode_horizon: int = 1,
        prefill_chunk: int | None = None,
        adaptive_horizon: int | None = None,
        prefix_cache: bool = False,
        spec_decode: int | None = None,
        spec_ngram: int = 3,
        kv_quant: str | None = None,
    ):
        if param_dtype is not None:
            # serving needs no f32 master weights; bf16 halves the weight
            # bytes each decode step reads
            params = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, param_dtype)
                if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
                else x,
                params,
            )
        if weight_quant is not None:
            # weight-only quantization (quantize/weights.py): decode at
            # serving batch is weight-bandwidth-bound, so after the
            # param_dtype=bf16 lever, int8 halves the streamed weight
            # bytes again and int4 quarters them. Scales stay f32
            # (quantized after the param_dtype cast, so nothing re-casts
            # them).
            if weight_quant not in ("int8", "int4"):
                raise ValueError("weight_quant must be 'int8', 'int4', or None")
            if mesh is not None and weight_quant == "int4":
                raise ValueError(
                    "weight_quant='int4' with mesh serving is not supported "
                    "(split-half nibble packing is not shardable along the "
                    "contraction axis; use 'int8')"
                )
            from quantizedattention_tpu.quantize.weights import quantize_lm_weights

            params = quantize_lm_weights(params, bits=4 if weight_quant == "int4" else 8)
        self.weight_quant = weight_quant
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.decode_horizon = decode_horizon
        # Adaptive bank sizing (round-4 verdict #6): when set, each decode
        # dispatch picks its own bank size — a power-of-two bucket (bounded
        # compiles) up to this cap, sized from the active slots' remaining
        # budgets: the LARGEST remaining when nothing is waiting (drain in
        # few dispatches — each dispatch+fetch cycle pays a fixed host
        # cost), the SMALLEST when requests wait (free slots fast,
        # no head-of-line blocking behind a long bank). Tokens are
        # identical either way (greedy); finished slots' surplus rows are
        # discarded at flush exactly as with a fixed horizon.
        if adaptive_horizon is not None and adaptive_horizon < 1:
            raise ValueError("adaptive_horizon must be >= 1")
        self.adaptive_horizon = adaptive_horizon
        # Speculative decoding (serve/spec.py + verify_step_batched): each
        # decode dispatch feeds the last token + spec_decode host-drafted
        # tokens (n-gram prompt lookup over the slot's own history) and
        # emits 1..spec_decode+1 tokens. Greedy: token-exact with plain
        # decode by construction. Sampled (temperature / top-k / top-p):
        # rejection-sampling acceptance, exact for the deterministic
        # n-gram drafter — see verify_step_batched's docstring. Unlike the
        # horizon banks (which amortize fetches but still run one model
        # pass per token), accepted drafts cost a single pass for several
        # tokens.
        self.spec_decode = spec_decode
        self.spec_ngram = spec_ngram
        # drafting scans every slot's full history per dispatch — native
        # C++ proposer (native/ngram.cpp) when the toolchain allows
        self._propose = (
            make_lookup(prefer_native=scheduler == "native")
            if spec_decode is not None else None
        )
        if spec_decode is not None:
            if spec_decode < 1:
                raise ValueError("spec_decode must be >= 1")
            # slotted (int8/int4) AND paged caches both verify: every cache
            # kind has a staircase verify + multi-token append + rollback
            # (models/transformer.py _cache_* dispatch). A paged verify may
            # transiently write up to spec_decode-1 tokens past a row's
            # page budget — those land on the reserved garbage page 0, and
            # every q row that can read them is itself beyond the budget,
            # so its token is discarded host-side.
            if decode_horizon != 1 or adaptive_horizon is not None:
                raise ValueError("spec_decode replaces decode_horizon/adaptive_horizon")
        self._spec_stats = {"steps": 0, "emitted": 0, "accepted": 0}
        if kv_quant not in (None, "int4"):
            raise ValueError("kv_quant must be 'int4' or None")
        if kv_quant == "int4" and cfg.max_seq >= 2048:
            import warnings

            # int4 KV is a CAPACITY feature (2x context/slots per card);
            # its decode runs plain JAX (unpack + dequant + einsum), not the
            # int8 cache's split-kv kernel, and its speed on the card is
            # not measured yet (PERF.md)
            warnings.warn(
                "kv_quant='int4' halves the KV cache's device memory (a "
                "capacity feature) but decodes through plain JAX with an "
                "unpack step; use it for memory, not throughput.",
                stacklevel=2,
            )

        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if prefill_chunk % 128 != 0 or prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be a positive multiple of 128")
            if cache == "paged" and prefill_chunk % page_size != 0:
                raise ValueError("prefill_chunk must be a multiple of page_size")
        # Automatic prefix caching (vLLM-style, host-side policy —
        # serve/prefix_store.py): requests sharing a token prefix reuse the
        # quantized KV pages already in the pool; only the tail prefills,
        # through the chunked path (which reads the cached prefix via the
        # slot's page table). Requires the paged cache (page identity is the
        # sharing unit) and prefill_chunk (the tail-prefill mechanism + the
        # compile-bounded chunk grid the reuse boundary rounds down to).
        self.prefix_cache = prefix_cache
        if prefix_cache:
            if cache != "paged":
                raise ValueError("prefix_cache=True requires cache='paged'")
            if prefill_chunk is None:
                raise ValueError(
                    "prefix_cache=True requires prefill_chunk (the tail-only "
                    "prefill rides the chunked-prefill path)"
                )
        self._pending: dict | None = None  # in-flight chunked prefill
        self._pending_decode_turn = False
        # Pipelined host path: every token-producing dispatch (horizon bank,
        # single decode step, prefill first-token) is enqueued here and
        # fetched only AFTER the next action has been dispatched, so the
        # host's fetch and scheduling overlap device work.
        # FIFO order preserves per-slot token order (a slot's prefill token
        # always precedes its decode tokens in the queue).
        self._pending_fetches: list[tuple] = []
        # Host-time ledger (round-4 verdict #6): decomposes a run()'s wall
        # clock into device-call dispatch time, blocking token-fetch time,
        # and the remaining host-side scheduling, so the gap between engine
        # tokens/s and the raw device step rate is attributable instead of
        # folklore. Counters reset per run().
        self._ledger = {"dispatches": 0, "fetches": 0,
                        "dispatch_s": 0.0, "fetch_s": 0.0}
        if top_k or top_p < 1.0:
            # a static Sampling spec rides the `temperature` argument of
            # every decode/prefill function (models/transformer.py
            # sample_token); a plain float stays a plain float so the
            # greedy/temperature-only jit caches are unchanged
            temperature = Sampling(float(temperature), top_k, top_p)
        self.temperature = temperature
        self._key = (
            jax.random.key(seed) if sampling_temperature(temperature) > 0.0 else None
        )
        self.sched = make_scheduler(n_slots, cfg.max_seq, prefer_native=scheduler == "native")

        self.cache_kind = cache
        self._mesh = mesh
        self._pager = None
        self._pagers = None  # per-data-shard pagers (mesh + paged)
        self._slots_per_shard = n_slots
        # page bookkeeping per slot: _slot_pages = PRIVATE pages (returned
        # to the pager on completion); _slot_shared = store-owned pages this
        # slot holds references on; _slot_row = the full table row in prefix
        # order; _slot_prefix = tokens covered by the shared prefix (the
        # tail prefill starts there).
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_shared: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_row: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_prefix: list[int] = [0] * n_slots
        self._prefix_stores = None
        if cache == "paged":
            # one allocator; the same page ids index every layer's pool.
            # Each layer's cache carries its own (tiny, identical) page
            # table / lengths copy: splitting them out would change the
            # PagedKVCache pytree every kernel consumes for an
            # admission-time-only saving of n_layers [n_slots, max_pages]
            # int32 scatters.
            self._page_size = page_size
            max_pages_per_seq = -(-cfg.max_seq // page_size)
            n_shards = 1 if mesh is None else int(mesh.shape["data"])
            if n_pages is None:
                n_pages = 1 + (n_slots // n_shards) * max_pages_per_seq  # page 0 reserved
            # Under a mesh every data shard owns a PRIVATE pool of n_pages
            # pages (page 0 of each pool reserved; page-table ids are
            # shard-local) and a private allocator — admission policy stays
            # host-side and per-shard, matching the device-side sharding.
            self._pagers = [
                make_pager(n_pages, prefer_native=scheduler == "native")
                for _ in range(n_shards)
            ]
            self._pager = self._pagers[0]
            if prefix_cache:
                # one store per shard: page ids are shard-local, and a slot
                # only ever shares with slots of the same data shard (the
                # pools are private — matching the device-side sharding)
                self._prefix_stores = [
                    make_prefix_store(page_size, prefer_native=scheduler == "native")
                    for _ in range(n_shards)
                ]
            if kv_quant == "int4":
                from quantizedattention_tpu.parallel.paged4_cache import init_paged4_cache

                mk_paged = init_paged4_cache
            else:
                mk_paged = init_paged_cache
            caches = [
                mk_paged(
                    cfg.n_kv_heads, n_pages * n_shards, n_slots, max_pages_per_seq,
                    cfg.head_dim, page_size,
                )
                for _ in params["layers"]
            ]
        elif cache == "slotted":
            # kv_quant="int4" swaps the slotted int8 cache for the packed
            # int4 cache (parallel/kv4_cache.py): half the KV HBM stream at
            # decode, absmax/7 per-token scales. Every slotted path — fused
            # + batched prefill, decode, horizon banks, spec verify —
            # dispatches by cache type (models/transformer.py _cache_*).
            #
            # spec_decode SLACK: a verify step appends spec+1 tokens before
            # rolling rejected ones back, so a slot at pos close to max_seq
            # transiently writes past it. The int8 append
            # (dynamic_update_slice) CLAMPS on overflow — which would shift
            # the whole write left and corrupt LIVE entries — so slotted
            # caches reserve one extra (lane/pack-aligned) block of scratch
            # rows; the length mask keeps them invisible to every read.
            # (Paged caches route overshoot to reserved page 0 instead.)
            slack = 0
            if spec_decode is not None:
                grain = 256 if kv_quant == "int4" else 128
                slack = -(-(spec_decode + 1) // grain) * grain
            if kv_quant == "int4":
                from quantizedattention_tpu.parallel.kv4_cache import init_kv4_cache

                caches = [
                    init_kv4_cache(n_slots, cfg.n_kv_heads,
                                   cfg.max_seq + slack, cfg.head_dim)
                    for _ in params["layers"]
                ]
            else:
                caches = [
                    init_kv_cache(n_slots, cfg.n_kv_heads,
                                  cfg.max_seq + slack, cfg.head_dim)
                    for _ in params["layers"]
                ]
        else:
            raise ValueError(f"unknown cache kind {cache!r}")
        last_tok = jnp.zeros((n_slots,), jnp.int32)
        pos = jnp.zeros((n_slots,), jnp.int32)
        active = jnp.zeros((n_slots,), bool)

        if mesh is not None:
            # "continuous batching across hosts": slots sharded over `data`,
            # heads over `model`. Decode, horizon decode AND prefill are all
            # explicit shard_maps (zero-collective attention + paged gather,
            # psum projections) — no GSPMD gathers anywhere on the path.
            if n_slots % mesh.shape["data"] != 0:
                raise ValueError("n_slots must divide the data axis")
            self._slots_per_shard = n_slots // int(mesh.shape["data"])
            pshard, cshard, vshard = serving_shardings(
                mesh, cfg, cache, weight_quant=weight_quant, kv_quant=kv_quant)
            params = jax.device_put(params, pshard)
            caches = jax.device_put(caches, cshard)
            last_tok = jax.device_put(last_tok, vshard)
            pos = jax.device_put(pos, vshard)
            active = jax.device_put(active, vshard)
            self._decode = make_sharded_decode_step(
                mesh, cfg, temperature=temperature, cache=cache,
                weight_quant=weight_quant, kv_quant=kv_quant,
            )
            self._horizon_fns = {}

            def _mesh_horizon(h, _mesh=mesh, _cfg=cfg, _t=temperature, _c=cache,
                              _w=weight_quant, _kq=kv_quant):
                if h not in self._horizon_fns:
                    self._horizon_fns[h] = make_sharded_decode_step(
                        _mesh, _cfg, temperature=_t, cache=_c, horizon=h,
                        weight_quant=_w, kv_quant=_kq,
                    )
                return self._horizon_fns[h]

            self._horizon_fn = _mesh_horizon
            self._prefill = make_sharded_prefill_slot(
                mesh, cfg, cache=cache, temperature=temperature,
                weight_quant=weight_quant, kv_quant=kv_quant,
            )
            if spec_decode is not None:
                # mesh x spec (round-4 verdict #7b): the staircase verify
                # is per-(slot, kv-head) like decode, so it shards on the
                # same (data, model) layout with zero extra collectives
                self._spec_fn = make_sharded_verify_step(
                    mesh, cfg, temperature=temperature, cache=cache,
                    weight_quant=weight_quant, kv_quant=kv_quant,
                )
            if prefill_chunk is not None:
                self._prefill_chunk_fn = make_sharded_prefill_chunk(
                    mesh, cfg, cache=cache, temperature=temperature,
                    weight_quant=weight_quant, kv_quant=kv_quant,
                )
        else:
            self._decode = jax.jit(
                functools.partial(decode_step_batched, cfg=cfg, temperature=temperature)
            )
            _horizon_jit = jax.jit(
                functools.partial(
                    decode_horizon_batched, cfg=cfg, temperature=temperature,
                ),
                static_argnames=("horizon",),
            )

            def _host_horizon(h, _fn=_horizon_jit):
                return functools.partial(_fn, horizon=h)

            self._horizon_fn = _host_horizon
            if spec_decode is not None:
                def _spec_step(params, caches, last_tok, draft, pos, active,
                               key=None, _cfg=cfg, _temp=temperature):
                    # rejection-sampling acceptance (exact for the n-gram
                    # point-mass drafter) lives in verify_step_batched;
                    # greedy when _temp == 0 / key is None
                    emitted, n_emit, caches = verify_step_batched(
                        params, caches, last_tok, draft, pos, active, _cfg,
                        temperature=_temp, key=key,
                    )
                    n = emitted.shape[0]
                    new_last = emitted[jnp.arange(n), n_emit - 1]
                    new_last = jnp.where(active, new_last, last_tok)
                    new_pos = pos + n_emit * active.astype(jnp.int32)
                    # pack n_emit as a trailing column: ONE host fetch
                    packed = jnp.concatenate([emitted, n_emit[:, None]], axis=1)
                    return packed, caches, new_last, new_pos

                self._spec_fn = jax.jit(_spec_step)
            self._prefill = jax.jit(
                functools.partial(prefill_slot, cfg=cfg, temperature=temperature)
            )
            # batched admission: several waiting requests prefill in ONE
            # dispatch (each dispatch pays a fixed host cost). Compiles per
            # (batch, bucket).
            self._prefill_slots_fn = jax.jit(
                functools.partial(prefill_slots, cfg=cfg, temperature=temperature)
            )
            self._prefill_chunk_fn = jax.jit(
                functools.partial(prefill_chunk_step, cfg=cfg, temperature=temperature),
                static_argnames=("chunk_start", "last"),
            )
        self.params = params
        self.caches = caches
        self.last_tok = last_tok
        self.pos = pos
        self.active = active

        self._next_id = 0
        self._submitted_at: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._tokens_generated = 0
        self._last_run_tokens_per_s = None
        self._budgets: dict[int, int] = {}
        self._prompts: dict[int, list[int]] = {}
        self._outputs: dict[int, list[int]] = {}
        self._finished: dict[int, GenerationResult] = {}
        self._callbacks: dict[int, object] = {}
        self._slot_req = [-1] * n_slots

    # -- client side --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32, on_token=None) -> int:
        """Queue a prompt (sequence of int token ids); returns a request id.

        on_token: optional streaming callback `fn(request_id, token, done)`
        invoked as generated tokens are RECORDED host-side (after each
        fetch — with horizon banks or speculative decode, several tokens
        of one request can stream back-to-back from a single fetch).
        `done=True` on the final token (EOS or budget); the finished
        GenerationResult still comes back from run() as usual.

        Raises ValueError if prompt + budget can never fit the KV capacity
        (the scheduler rejects it rather than letting it pend forever).
        """
        prompt = [int(t) for t in prompt]
        rid = self._next_id
        self._next_id += 1
        if self._pagers is not None:
            n_need = -(-(len(prompt) + max_new_tokens) // self._page_size)
            # capacity bound is PER data shard (each owns a private pool)
            total_usable = self.caches[0].n_pages // len(self._pagers) - 1
            if n_need > total_usable:
                raise ValueError(
                    f"request rejected: needs {n_need} pages > pool of {total_usable}"
                )
        if not self.sched.submit(rid, len(prompt), max_new_tokens):
            raise ValueError(
                f"request rejected: prompt {len(prompt)} + budget {max_new_tokens} "
                f"> KV capacity {self.cfg.max_seq}"
            )
        self._prompts[rid] = prompt
        self._outputs[rid] = []
        self._budgets[rid] = max_new_tokens
        self._submitted_at[rid] = time.perf_counter()
        if on_token is not None:
            self._callbacks[rid] = on_token
        return rid

    def run(self) -> dict[int, GenerationResult]:
        """Drive steps until queue and slots drain; returns all results."""
        t0 = time.perf_counter()
        n0 = self._tokens_generated
        self._ledger = {"dispatches": 0, "fetches": 0,
                        "dispatch_s": 0.0, "fetch_s": 0.0}
        self._spec_stats = {"steps": 0, "emitted": 0, "accepted": 0}
        while self.step():
            pass
        dt = time.perf_counter() - t0
        self._ledger["wall_s"] = dt
        self._ledger["tokens"] = self._tokens_generated - n0
        self._ledger["other_host_s"] = max(
            0.0, dt - self._ledger["dispatch_s"] - self._ledger["fetch_s"])
        if dt > 0:
            self._last_run_tokens_per_s = (self._tokens_generated - n0) / dt
        out, self._finished = self._finished, {}
        return out

    def ledger(self) -> dict:
        """The last run()'s host-time decomposition: `dispatches`/`fetches`
        counts, `dispatch_s` (blocking time inside device-call invocations),
        `fetch_s` (blocking token fetches), `other_host_s` (scheduling +
        Python), `wall_s`, `tokens`. dispatch_s + fetch_s + other_host_s =
        wall_s; a fetch blocks only as long as the device work it waits
        for, unless it overlapped an in-flight dispatch."""
        return dict(self._ledger)

    def stats(self) -> dict:
        """Serving observability: queue/slot occupancy, token + page counts."""
        s = {
            "active": self.sched.num_active,
            "waiting": self.sched.num_waiting,
            "completed": self.sched.num_completed,
            "tokens_generated": self._tokens_generated,
            "last_run_tokens_per_s": self._last_run_tokens_per_s,
            "cache": self.cache_kind,
            "decode_horizon": self.decode_horizon,
        }
        if self._pagers is not None:
            s["pages_free"] = sum(p.num_free for p in self._pagers)
        if self._prefix_stores is not None:
            s["prefix_nodes"] = sum(st.n_nodes for st in self._prefix_stores)
            s["prefix_hit_pages"] = sum(st.hits for st in self._prefix_stores)
            s["prefix_miss_pages"] = sum(st.misses for st in self._prefix_stores)
        if self.spec_decode is not None:
            sp = dict(self._spec_stats)
            # slot-steps = emitted - accepted (each slot-step emits exactly
            # one non-draft bonus token); mean tokens banked per model pass
            sp["tokens_per_pass"] = (
                sp["emitted"] / max(1, sp["emitted"] - sp["accepted"])
            )
            s["spec"] = sp
        s["ledger"] = dict(self._ledger)
        return s

    # -- engine side ---------------------------------------------------------

    def step(self) -> bool:
        """One engine action. False if idle.

        With an in-flight chunked prefill, actions alternate between one
        decode step (running slots keep emitting tokens) and one prompt
        chunk — a long prompt no longer stalls decodes to completion.
        Otherwise: one scheduler action (prefill XOR batched decode).
        """
        if self._pending is not None:
            has_decodes = any(r >= 0 for r in self._slot_req)
            if self._pending_decode_turn and has_decodes:
                self._pending_decode_turn = False
                self._do_decode()
            else:
                self._pending_decode_turn = True
                self._do_prefill_chunk()
            return True
        action, rid, slot = self.sched.next_action()
        if action == IDLE:
            # drain pipelined fetches before declaring idle (their tokens
            # may finish requests or free slots)
            return self._flush_pending()
        if action == PREFILL:
            self._do_prefill(rid, slot)
        elif action == DECODE:
            self._do_decode()
        return True

    def _record(self, slot: int, token: int):
        rid = self._slot_req[slot]
        self._outputs[rid].append(token)
        self._tokens_generated += 1
        now = time.perf_counter()
        if rid not in self._ttft:
            self._ttft[rid] = now - self._submitted_at[rid]
        is_eos = self.eos_id is not None and token == self.eos_id
        finished = self.sched.report_token(slot, is_eos)
        cb = self._callbacks.get(rid)
        if cb is not None:
            cb(rid, token, finished)
            if finished:
                self._callbacks.pop(rid, None)
        if finished:
            self._finished[rid] = GenerationResult(
                request_id=rid,
                prompt=self._prompts.pop(rid),
                tokens=self._outputs.pop(rid),
                finish_reason="eos" if is_eos else "length",
                ttft_s=self._ttft.pop(rid),
                duration_s=now - self._submitted_at.pop(rid),
            )
            self._budgets.pop(rid, None)
            self._slot_req[slot] = -1
            self.active = self.active.at[slot].set(False)
            if self._pagers is not None:
                shard = slot // self._slots_per_shard
                if self._slot_pages[slot]:
                    self._pagers[shard].free(self._slot_pages[slot])
                if self._prefix_stores is not None and self._slot_shared[slot]:
                    # shared pages stay CACHED in the store (refcount drops;
                    # eviction returns them to the pager under pressure)
                    self._prefix_stores[shard].release(self._slot_shared[slot])
                self._slot_pages[slot] = []
                self._slot_shared[slot] = []
                self._slot_row[slot] = []

    def _next_key(self):
        if self._key is None:
            return None
        self._key, sub = jax.random.split(self._key)
        return sub

    def _start_chunked_prefill(self, rid: int, slot: int, prompt):
        """Begin chunked admission: the slot is reserved now, and step()
        interleaves decode steps between the chunks. With a prefix-cache
        hit, the first chunk starts AT the cached boundary (a chunk-grid
        multiple — _admit_pages rounds it down) and attends to the shared
        prefix pages through the slot's table, exactly as any later chunk
        attends to its own earlier chunks."""
        start = self._slot_prefix[slot] // self.prefill_chunk if self._slot_prefix[slot] else 0
        self._pending = {"rid": rid, "slot": slot, "prompt": prompt, "next": start}
        self._pending_decode_turn = True
        self._do_prefill_chunk()

    def _do_prefill_chunk(self):
        """Advance the in-flight chunked prefill by one chunk."""
        p = self._pending
        prompt, slot, rid = p["prompt"], p["slot"], p["rid"]
        chunk = self.prefill_chunk
        i = p["next"]
        n_chunks = -(-len(prompt) // chunk)
        sl = prompt[i * chunk:(i + 1) * chunk]
        tokens = jnp.asarray(sl + [0] * (chunk - len(sl)), jnp.int32)
        last = i == n_chunks - 1
        t0 = time.perf_counter()
        tok, self.caches = self._prefill_chunk_fn(
            self.params, self.caches, tokens,
            chunk_start=i * chunk, true_end=jnp.int32(len(prompt)),
            slot=jnp.int32(slot), last=last, key=self._next_key() if last else None,
        )
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        if not last:
            p["next"] = i + 1
            return
        self._pending = None
        self._slot_req[slot] = rid
        self._register_prefix(slot, rid)
        # first token stays on device (no host fetch): it seeds last_tok
        # directly and its host-side record is deferred to the next flush
        self.last_tok = self.last_tok.at[slot].set(tok)
        self.pos = self.pos.at[slot].set(len(prompt))
        self.active = self.active.at[slot].set(True)
        self._flush_pending()
        self._pending_fetches.append(("prefill", tok, (slot, rid)))

    def _needs_chunking(self, prompt) -> bool:
        return self.prefill_chunk is not None and len(prompt) > self.prefill_chunk

    def _pad_len(self, prompt) -> int:
        if self.cache_kind == "paged":
            return -(-max(len(prompt), 1) // self._page_size) * self._page_size
        # Clamp the power-of-two bucket at the (128-rounded) cache
        # capacity: for a non-power-of-two max_seq a long prompt would
        # otherwise prefill at a bucket beyond capacity — numerically
        # safe (write_kv_slot trims) but wasted compile + compute.
        return min(_bucket(len(prompt)), -(-self.cfg.max_seq // 128) * 128)

    def _admit_pages(self, rid: int, slot: int) -> bool:
        """Paged admission: allocate pages for the whole prompt+generation
        budget up front (all-or-nothing; budget known at submit, so no
        mid-flight OOM) from the pool of the data shard that owns `slot`.
        False (and the request requeued to the queue FRONT) when the pool
        is exhausted — completions free pages, so a retry succeeds later;
        submit() guarantees the request fits an empty pool, so no live-lock.
        """
        ps = self._page_size
        shard = slot // self._slots_per_shard
        prompt = self._prompts[rid]
        n_need = -(-(len(prompt) + self._budgets[rid]) // ps)

        # prefix-cache hit: reuse cached FULL pages for the longest matching
        # prefix, rounded DOWN to the chunk grid (the tail prefill reuses
        # the already-compiled chunk functions) and capped so at least one
        # prompt token is always computed (the last-token logits seed the
        # first sampled token).
        hit: list[int] = []
        store = None if self._prefix_stores is None else self._prefix_stores[shard]
        if store is not None:
            chunk_pages = self.prefill_chunk // ps
            hit = store.lookup(prompt, max_pages=(len(prompt) - 1) // ps)
            hit = hit[: (len(hit) // chunk_pages) * chunk_pages]
            if hit:
                # reference the hit BEFORE any eviction can run below
                store.acquire(hit)

        n_fresh = n_need - len(hit)
        pager = self._pagers[shard]
        pages = pager.alloc(n_fresh)
        if pages is None and store is not None:
            # pool pressure: recycle cached-but-unreferenced store pages
            evicted = store.evict(n_fresh - pager.num_free)
            if evicted:
                pager.free(evicted)
                pages = pager.alloc(n_fresh)
        if pages is None:
            if hit:
                store.release(hit)
            self.sched.requeue(slot)
            return False
        row = hit + pages
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = hit
        self._slot_row[slot] = row
        self._slot_prefix[slot] = len(hit) * ps
        max_pages = self.caches[0].page_table.shape[1]
        table_row = jnp.asarray(row + [0] * (max_pages - len(row)), jnp.int32)
        self.caches = [
            assign_pages(c, jnp.int32(slot), table_row) for c in self.caches
        ]
        return True

    def _register_prefix(self, slot: int, rid: int):
        """Offer the freshly prefilled prompt's immutable (full) pages to
        the prefix store; pages the store adopts move from the slot's
        private list to its shared list (released, not freed, on drop)."""
        if self._prefix_stores is None:
            return
        prompt = self._prompts[rid]
        n_full = len(prompt) // self._page_size
        if n_full == 0:
            return
        store = self._prefix_stores[slot // self._slots_per_shard]
        owned = store.register(prompt, self._slot_row[slot][:n_full])
        owned_set = set(owned)
        self._slot_shared[slot] = owned
        self._slot_pages[slot] = [p for p in self._slot_row[slot] if p not in owned_set]

    def _do_prefill(self, rid: int, slot: int):
        prompt = self._prompts[rid]
        if self.cache_kind == "paged" and not self._admit_pages(rid, slot):
            if self.sched.num_active > 0:
                self._do_decode()
            return
        if self._needs_chunking(prompt) or self._slot_prefix[slot] > 0:
            # pages (if paged) are assigned; the chunk grid is page-aligned.
            # A prefix-cache hit ALWAYS takes this path (even a short tail):
            # the chunked step is the tail-only prefill mechanism.
            self._start_chunked_prefill(rid, slot, prompt)
            return
        # BATCHED ADMISSION (single-host): while more requests are waiting
        # and slots are free the scheduler keeps answering PREFILL — drain
        # them into ONE multi-slot dispatch instead of paying a fixed host
        # dispatch cost per request
        batch = [(rid, slot, prompt)]
        if self._mesh is None:
            while len(batch) < self.n_slots and self.sched.num_waiting > 0:
                action2, rid2, slot2 = self.sched.next_action()
                if action2 != PREFILL:
                    break  # defensive: policy admits while waiting+free
                p2 = self._prompts[rid2]
                if self.cache_kind == "paged" and not self._admit_pages(rid2, slot2):
                    break  # rid2 requeued; serve what we have
                if self._needs_chunking(p2) or self._slot_prefix[slot2] > 0:
                    # serve the collected batch, then chunk this one
                    self._dispatch_prefills(batch)
                    self._start_chunked_prefill(rid2, slot2, p2)
                    return
                batch.append((rid2, slot2, p2))
        self._dispatch_prefills(batch)

    def _dispatch_prefills(self, batch):
        if len(batch) == 1:
            rid, slot, prompt = batch[0]
            t_pad = self._pad_len(prompt)
            tokens = jnp.asarray(prompt + [0] * (t_pad - len(prompt)), jnp.int32)
            t0 = time.perf_counter()
            first_tok, self.caches = self._prefill(
                self.params, self.caches, tokens, jnp.int32(len(prompt)),
                jnp.int32(slot), key=self._next_key(),
            )
            self._ledger["dispatches"] += 1
            self._ledger["dispatch_s"] += time.perf_counter() - t0
            self._slot_req[slot] = rid
            self._register_prefix(slot, rid)
            # seed last_tok with the DEVICE scalar — no host fetch on this
            # path; the host-side record is deferred to the next flush
            # (dispatch-before-fetch, same as the decode banks)
            self.last_tok = self.last_tok.at[slot].set(first_tok)
            self.pos = self.pos.at[slot].set(len(prompt))
            self.active = self.active.at[slot].set(True)
            self._flush_pending()
            self._pending_fetches.append(("prefill", first_tok, (slot, rid)))
            return
        t_pad = max(self._pad_len(p) for _, _, p in batch)
        tokens = jnp.asarray(
            [p + [0] * (t_pad - len(p)) for _, _, p in batch], jnp.int32)
        true_lens = jnp.asarray([len(p) for _, _, p in batch], jnp.int32)
        slots = jnp.asarray([s for _, s, _ in batch], jnp.int32)
        t0 = time.perf_counter()
        toks, self.caches = self._prefill_slots_fn(
            self.params, self.caches, tokens, true_lens, slots,
            key=self._next_key(),
        )
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        for i, (rid_i, slot_i, _) in enumerate(batch):
            self._slot_req[slot_i] = rid_i
            self._register_prefix(slot_i, rid_i)
        self.last_tok = self.last_tok.at[slots].set(toks)
        self.pos = self.pos.at[slots].set(true_lens)
        self.active = self.active.at[slots].set(True)
        self._flush_pending()
        self._pending_fetches.append(
            ("prefills", toks, [(s, r) for r, s, _ in batch]))

    def _flush_pending(self) -> bool:
        """Fetch + record every previously dispatched token batch, in
        dispatch order (the fetches overlap whatever was dispatched after
        them). Returns True if anything was flushed."""
        if not self._pending_fetches:
            return False
        entries, self._pending_fetches = self._pending_fetches, []
        t0 = time.perf_counter()
        self._ledger["fetches"] += len(entries)
        for kind, arr, owners in entries:
            if kind == "bank":
                toks = np.asarray(arr)  # [n_steps, n_slots]
                for step_toks in toks:
                    for slot, rid in owners:
                        # the slot must still belong to the request it was
                        # decoding when this bank was dispatched (not finished
                        # mid-horizon, not re-admitted to a new request since)
                        if self._slot_req[slot] == rid:
                            self._record(slot, int(step_toks[slot]))
            elif kind == "prefills":  # [B] first tokens of a batched admission
                toks = np.asarray(arr)
                for i, (slot, rid) in enumerate(owners):
                    if self._slot_req[slot] == rid:
                        self._record(slot, int(toks[i]))
            else:  # "prefill": scalar first token of one admission
                slot, rid = owners
                if self._slot_req[slot] == rid:
                    self._record(slot, int(arr))
        self._ledger["fetch_s"] += time.perf_counter() - t0
        return True

    def _pending_token_counts(self):
        """Tokens each (slot, rid) will record once the pending fetches
        flush — the lag the dispatch-before-fetch pipeline introduces."""
        counts: dict = {}
        for kind, arr, owners in self._pending_fetches:
            if kind == "bank":
                for slot, rid in owners:
                    counts[(slot, rid)] = counts.get((slot, rid), 0) + arr.shape[0]
            elif kind == "prefills":
                for slot, rid in owners:
                    counts[(slot, rid)] = counts.get((slot, rid), 0) + 1
            else:
                slot, rid = owners
                counts[(slot, rid)] = counts.get((slot, rid), 0) + 1
        return counts

    def _pick_horizon(self, active_slots) -> int:
        """Bank size for this dispatch. Fixed `decode_horizon` unless
        `adaptive_horizon` is set; then a power-of-two bucket (bounded
        compile count) sized from remaining budgets — largest remaining
        when the queue is empty (fewest dispatch+fetch cycles to drain),
        smallest when requests wait (slots free promptly for admission)."""
        cap = self.adaptive_horizon
        if cap is None:
            return self.decode_horizon
        counts = self._pending_token_counts()
        rem = []
        for s in active_slots:
            rid = self._slot_req[s]
            r = (self._budgets[rid] - len(self._outputs[rid])
                 - counts.get((s, rid), 0))
            if r > 0:
                rem.append(r)
        if not rem:
            return 1
        if self.sched.num_waiting > 0:
            # floor: the bank must not outlive the soonest-finishing slot,
            # or admission of the waiting request stalls behind it
            target = max(1, min(min(rem), cap))
            return 1 << (target.bit_length() - 1)
        # queue empty: ceil — one slightly-surplus bank beats a tail of
        # tiny banks (each dispatch+fetch cycle pays a fixed host cost;
        # surplus rows are the established mid-horizon-finish
        # behavior and are discarded at flush)
        target = max(1, min(max(rem), cap))
        ceil_pow2 = 1 << (target - 1).bit_length()
        return min(ceil_pow2, cap)

    def _do_spec_decode(self):
        """One speculative decode dispatch: draft host-side by n-gram
        lookup, verify + emit 1..spec_decode+1 tokens per slot on device.

        Drafting needs each slot's CURRENT history, so this path flushes
        pending fetches before dispatching (no dispatch-before-fetch
        pipelining); the accepted drafts are what amortize the host
        round-trip instead."""
        self._flush_pending()
        active = [i for i in range(self.n_slots) if self._slot_req[i] >= 0]
        if not active:
            return
        k = self.spec_decode
        drafts = np.zeros((self.n_slots, k), np.int32)
        for s in active:
            rid = self._slot_req[s]
            prop = self._propose(
                self._prompts[rid] + self._outputs[rid], k,
                max_ngram=self.spec_ngram,
            )
            drafts[s, : len(prop)] = prop
        t0 = time.perf_counter()
        packed, self.caches, self.last_tok, self.pos = self._spec_fn(
            self.params, self.caches, self.last_tok,
            jnp.asarray(drafts), self.pos, self.active,
            key=self._next_key() if self._key is not None else None,
        )
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        arr = np.asarray(packed)  # [n_slots, k+2]: emitted tokens | n_emit
        self._ledger["fetches"] += 1
        self._ledger["fetch_s"] += time.perf_counter() - t0
        self._spec_stats["steps"] += 1
        for s in active:
            rid = self._slot_req[s]
            n_emit = int(arr[s, -1])
            self._spec_stats["emitted"] += n_emit
            self._spec_stats["accepted"] += n_emit - 1
            for j in range(n_emit):
                if self._slot_req[s] != rid:
                    break  # finished (EOS/budget) mid-emission: surplus
                self._record(s, int(arr[s, j]))

    def _do_decode(self):
        if self.spec_decode is not None:
            return self._do_spec_decode()
        active_before = [i for i in range(self.n_slots) if self._slot_req[i] >= 0]
        if active_before and self._pending_fetches:
            # if the PENDING fetches already satisfy every active slot's
            # remaining budget, dispatching another bank is provably surplus
            # (budget is a hard cap; EOS can only finish sooner) — flush
            # instead and let the scheduler decide next
            counts = self._pending_token_counts()

            def left(s):
                rid = self._slot_req[s]
                return (self._budgets[rid] - len(self._outputs[rid])
                        - counts.get((s, rid), 0))

            if all(left(s) <= 0 for s in active_before):
                self._flush_pending()
                return
        # PIPELINED dispatch-before-fetch on every path: dispatch step/bank
        # N+1 BEFORE fetching N's tokens, so the host's fetch overlaps the
        # next step's device execution.
        # EOS/budget bookkeeping lags one action — surplus tokens decoded by
        # a since-finished slot are discarded at flush (the slot kept
        # decoding into its own soon-to-be-reset cache, masked by `active`).
        # horizon choice is host scheduling work — keep it OUT of the
        # dispatch_s bucket (ledger() documents dispatch_s as blocking time
        # inside device-call invocations only)
        h = self._pick_horizon(active_before)
        t0 = time.perf_counter()
        if h > 1:
            # K chained steps in one jit; ONE host fetch banks K tokens.
            bank, self.caches, self.last_tok, self.pos = self._horizon_fn(h)(
                self.params, self.caches, self.last_tok, self.pos, self.active,
                key=self._next_key(),
            )
        else:
            next_tok, self.caches = self._decode(
                self.params, self.caches, self.last_tok, self.pos, self.active,
                key=self._next_key(),
            )
            self.last_tok = next_tok
            self.pos = self.pos + self.active.astype(jnp.int32)
            bank = next_tok[None]  # a bank of one step
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        self._flush_pending()
        # the flush may have finished requests that this (already
        # dispatched) bank is still decoding — exclude them: their rows
        # are surplus
        owners = [(s, self._slot_req[s]) for s in active_before
                  if self._slot_req[s] >= 0]
        self._pending_fetches.append(("bank", bank, owners))


# ---------------------------------------------------------------------------
# Multi-host decode: slots on `data`, heads on `model`
# ---------------------------------------------------------------------------

def _sharded_decode_step(params, caches, last_tok, pos, active, key,
                         cfg: TransformerConfig, temperature: float = 0.0):
    """Per-device continuous-batching decode step (runs inside shard_map):
    _sharded_decode_logits, then one token per slot."""
    logits, new_caches = _sharded_decode_logits(params, caches, last_tok, pos, active, cfg)
    if sampling_temperature(temperature) == 0.0 or key is None:
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    else:
        # decorrelate across data shards: fold the global slot id into the
        # (replicated) step key, one sample_token draw per row (handles
        # temperature-only floats and top-k/top-p Sampling specs alike)
        from quantizedattention_tpu.models.transformer import sample_token

        b_loc = last_tok.shape[0]
        rows = jax.lax.axis_index("data") * b_loc + jnp.arange(b_loc)
        keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(rows)
        tok = jax.vmap(
            lambda kk, lg: sample_token(lg, temperature, kk)
        )(keys, logits)
    return tok, new_caches


def _sharded_decode_logits(params, caches, last_tok, pos, active,
                           cfg: TransformerConfig):
    """Per-device decode step up to its logits [slots_loc, vocab] (runs
    inside shard_map).

    Local shapes: last_tok/pos/active [slots_loc]; cache rows [slots_loc,
    kv_loc, max_len, d]; wq/wk/wv output-sharded, wo/w2 contraction-sharded
    (psum) — the Megatron layout of models/sharded_train.py. Decode
    attention is per-(slot, kv-head) and therefore communication-free.
    The paged cache works the same way: each data shard owns a private page
    pool + the table rows of its slots (local page ids), so the paged
    gather also needs zero collectives.
    """
    from quantizedattention_tpu.parallel.paged_cache import (
        PagedKVCache,
        append_token_paged,
        paged_decode_attention,
    )

    n_model = jax.lax.axis_size("model")
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model
    b_loc = last_tok.shape[0]

    x = embedding_lookup(params["embed"], last_tok)[:, None, :]
    positions = pos[:, None]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q = mm(h, layer["wq"]).reshape(b_loc, 1, h_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        k = mm(h, layer["wk"]).reshape(b_loc, 1, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        v = mm(h, layer["wv"]).reshape(b_loc, 1, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        q = rope(q, positions, cfg.rope_base)
        k = rope(k, positions, cfg.rope_base)
        if isinstance(cache, PagedKVCache):
            cache = append_token_paged(cache, k, v, active)
            o = paged_decode_attention(q[:, :, 0, :], cache)
        else:
            cache = _cache_append(cache, k, v, active=active)
            o = _cache_decode(q[:, :, 0, :], cache)
        o = o.reshape(b_loc, 1, h_loc * cfg.head_dim)
        x = x + jax.lax.psum(mm(o.astype(x.dtype), layer["wo"]), "model")
        hh = rmsnorm(x, layer["ln2"])
        x = x + jax.lax.psum(mm(jax.nn.gelu(mm(hh, layer["w1"])), layer["w2"]), "model")
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    return mm(x[:, 0], params["unembed"]), new_caches


def _sharded_verify_step(params, caches, last_tok, draft, pos, active, key,
                         cfg: TransformerConfig, temperature: float = 0.0):
    """Per-device speculative VERIFY step (runs inside shard_map) — the
    mesh twin of models.transformer.verify_step_batched with
    _sharded_decode_step's Megatron layout. The verify paths are
    per-(slot, kv-head) exactly like decode, so the staircase attention is
    communication-free: the only collectives are the same wo/w2 psums every
    sharded step pays. Drafting, acceptance, and rollback are all per-slot
    (data-shard local); sampled targets key their draws by (GLOBAL row,
    absolute position) — the verify_step_batched contract."""
    from quantizedattention_tpu.models.transformer import (
        _cache_append, _cache_rollback, _cache_verify, sample_token,
        sampling_temperature,
    )

    n_model = jax.lax.axis_size("model")
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model
    b_loc, s_draft = draft.shape
    s = s_draft + 1

    tokens = jnp.concatenate([last_tok[:, None], draft], axis=1)  # [b_loc, s]
    x = embedding_lookup(params["embed"], tokens)
    positions = pos[:, None] + jnp.arange(s)[None]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q = mm(h, layer["wq"]).reshape(b_loc, s, h_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        k = mm(h, layer["wk"]).reshape(b_loc, s, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        v = mm(h, layer["wv"]).reshape(b_loc, s, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        q = rope(q, positions, cfg.rope_base)
        k = rope(k, positions, cfg.rope_base)
        cache = _cache_append(cache, k, v, active=active)
        o = _cache_verify(q, cache)  # [b_loc, h_loc, s, d], causal staircase
        o = o.transpose(0, 2, 1, 3).reshape(b_loc, s, h_loc * cfg.head_dim)
        x = x + jax.lax.psum(mm(o.astype(x.dtype), layer["wo"]), "model")
        hh = rmsnorm(x, layer["ln2"])
        x = x + jax.lax.psum(mm(jax.nn.gelu(mm(hh, layer["w1"])), layer["w2"]), "model")
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    logits = mm(x, params["unembed"])  # [b_loc, s, vocab]
    if sampling_temperature(temperature) == 0.0 or key is None:
        targets = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    else:
        rows = jax.lax.axis_index("data") * b_loc + jnp.arange(b_loc)
        row_keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(rows)
        out_pos = positions + 1

        def draw(row_key, lg, p):
            return sample_token(lg, temperature, jax.random.fold_in(row_key, p))

        targets = jax.vmap(
            jax.vmap(draw, in_axes=(None, 0, 0))
        )(row_keys, logits, out_pos)
    match = (draft == targets[:, :-1]).astype(jnp.int32)
    n_acc = jnp.sum(jnp.cumprod(match, axis=1), axis=1)
    emitted = jnp.where(
        jnp.arange(s)[None] < n_acc[:, None],
        jnp.pad(draft, ((0, 0), (0, 1))),
        targets,
    )
    drop = (s - 1 - n_acc) * active.astype(jnp.int32)
    new_caches = [_cache_rollback(c, drop) for c in new_caches]
    n_emit = n_acc + 1
    new_last = emitted[jnp.arange(b_loc), n_emit - 1]
    new_last = jnp.where(active, new_last, last_tok)
    new_pos = pos + n_emit * active.astype(jnp.int32)
    packed = jnp.concatenate([emitted, n_emit[:, None]], axis=1)
    return packed, new_caches, new_last, new_pos


def make_sharded_verify_step(mesh: Mesh, cfg: TransformerConfig,
                             temperature: float = 0.0, cache: str = "slotted",
                             weight_quant: str | None = None,
                             kv_quant: str | None = None):
    """Jitted multi-chip speculative verify step: (params, caches,
    last_tok, draft, pos, active, key=None) -> (packed [n_slots, s+1],
    caches, last_tok, pos) — the mesh counterpart of the single-host
    engine _spec_fn (same packed emitted|n_emit contract). Slots shard
    over `data` (drafts ride the slot axis), heads over `model`."""
    from quantizedattention_tpu.models.sharded_train import param_specs

    if cfg.n_kv_heads % mesh.shape["model"] != 0:
        raise ValueError("n_kv_heads must divide the model axis")

    specs = _maybe_quantized_specs(param_specs(cfg), weight_quant)
    vec = P("data")
    mat = P("data", None)
    cspecs = _layer_cache_specs(cfg, cache, kv_quant)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, cspecs, vec, mat, vec, vec, P()),
        out_specs=(mat, cspecs, vec, vec),
        check_vma=False,
    )
    def sharded(params, caches, last_tok, draft, pos, active, key):
        return _sharded_verify_step(
            params, caches, last_tok, draft, pos, active, key, cfg, temperature
        )

    _step = jax.jit(sharded)

    def step(params, caches, last_tok, draft, pos, active, key=None):
        if key is None:
            key = jax.random.key(0)  # unused placeholder (greedy path)
        return _step(params, caches, last_tok, draft, pos, active, key)

    return step


def cache_specs(data_axis: str = "data", model_axis: str = "model") -> QuantizedKVCache:
    """PartitionSpec tree for one layer's QuantizedKVCache: slots on data,
    KV heads on model, sequence+scales replicated along their own axes."""
    payload = P(data_axis, model_axis, None, None)
    scales = P(data_axis, model_axis, None)
    return QuantizedKVCache(
        k_i8=payload, sk=scales, v_i8=payload, sv=scales, length=P(data_axis)
    )


def cache4_specs(data_axis: str = "data", model_axis: str = "model"):
    """PartitionSpec tree for one layer's Int4KVCache: same (slots on data,
    KV heads on model) layout as cache_specs — the pack-block axis is the
    (unsharded) token axis, so nibble packing and sharding never interact."""
    from quantizedattention_tpu.parallel.kv4_cache import Int4KVCache

    payload = P(data_axis, model_axis, None, None)
    scales = P(data_axis, model_axis, None)
    return Int4KVCache(
        k_p=payload, sk=scales, v_p=payload, sv=scales, length=P(data_axis)
    )


def paged_cache_specs(data_axis: str = "data", model_axis: str = "model"):
    """PartitionSpec tree for one layer's PagedKVCache under the serving
    mesh: each data shard owns a PRIVATE page pool (pages sharded on data,
    page-table values are shard-local ids) and the table rows of its slots;
    kv heads shard on model."""
    from quantizedattention_tpu.parallel.paged_cache import PagedKVCache

    return PagedKVCache(
        k_pages=P(model_axis, data_axis, None, None),
        sk=P(data_axis, model_axis, None),
        v_pages=P(model_axis, data_axis, None, None),
        sv=P(data_axis, model_axis, None),
        page_table=P(data_axis, None),
        lengths=P(data_axis),
    )


def paged4_cache_specs(data_axis: str = "data", model_axis: str = "model"):
    """Paged4KVCache twin of paged_cache_specs (same private-pool-per-data-
    shard layout; the in-page pack axis is unsharded)."""
    from quantizedattention_tpu.parallel.paged4_cache import Paged4KVCache

    return Paged4KVCache(
        k_p=P(model_axis, data_axis, None, None),
        sk=P(data_axis, model_axis, None),
        v_p=P(model_axis, data_axis, None, None),
        sv=P(data_axis, model_axis, None),
        page_table=P(data_axis, None),
        lengths=P(data_axis),
    )


def _layer_cache_specs(cfg: TransformerConfig, cache: str,
                       kv_quant: str | None = None):
    if cache == "paged":
        one = paged4_cache_specs() if kv_quant == "int4" else paged_cache_specs()
    elif kv_quant == "int4":
        one = cache4_specs()
    else:
        one = cache_specs()
    return [one for _ in range(cfg.n_layers)]


def _maybe_quantized_specs(specs, weight_quant):
    if weight_quant is None:
        return specs
    from quantizedattention_tpu.quantize.weights import quantize_lm_specs

    return quantize_lm_specs(specs)


def make_sharded_decode_step(mesh: Mesh, cfg: TransformerConfig,
                             temperature: float = 0.0, cache: str = "slotted",
                             horizon: int = 1,
                             weight_quant: str | None = None,
                             kv_quant: str | None = None):
    """Jitted multi-chip decode step: (params, caches, last_tok, pos, active,
    key=None) -> (next_tok, caches) — or, with horizon > 1, (bank [horizon,
    n_slots], caches, last_tok, pos) with the same banked-token contract as
    decode_horizon_batched. Slots shard over `data`, heads over `model`;
    cache='paged' runs the paged gather per data shard (private page pool).

    Param layout = models.sharded_train.param_specs (Megatron TP). Use
    jax.device_put with `serving_shardings(mesh, cfg, cache)` to place the
    operands.
    """
    from quantizedattention_tpu.models.sharded_train import param_specs

    if cfg.n_kv_heads % mesh.shape["model"] != 0:
        raise ValueError("n_kv_heads must divide the model axis")

    specs = _maybe_quantized_specs(param_specs(cfg), weight_quant)
    vec = P("data")
    cspecs = _layer_cache_specs(cfg, cache, kv_quant)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, cspecs, vec, vec, vec, P()),
        out_specs=(vec, cspecs),
        check_vma=False,
    )
    def sharded(params, caches, last_tok, pos, active, key):
        return _sharded_decode_step(
            params, caches, last_tok, pos, active, key, cfg, temperature
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, cspecs, vec, vec, vec, P()),
        out_specs=(P(None, "data"), cspecs, vec, vec),
        check_vma=False,
    )
    def sharded_horizon(params, caches, last_tok, pos, active, key):
        bank = jnp.zeros((horizon, last_tok.shape[0]), jnp.int32)

        def body(i, state):
            bank, caches, last_tok, pos = state
            k_i = (
                None
                if sampling_temperature(temperature) == 0.0
                else jax.random.fold_in(key, i)
            )
            nxt, caches = _sharded_decode_step(
                params, caches, last_tok, pos, active, k_i, cfg, temperature
            )
            return (bank.at[i].set(nxt), caches, nxt,
                    pos + active.astype(jnp.int32))

        # fori_loop: bank compile cost is O(1) in horizon (adaptive buckets
        # up to 128 — see decode_horizon_batched)
        return jax.lax.fori_loop(0, horizon, body, (bank, caches, last_tok, pos))

    fn = sharded if horizon <= 1 else sharded_horizon
    _step = jax.jit(fn)

    def step(params, caches, last_tok, pos, active, key=None):
        if key is None:
            if sampling_temperature(temperature) > 0.0:
                raise ValueError("temperature > 0 requires a PRNG key per step")
            key = jax.random.key(0)  # unused placeholder (greedy path)
        return _step(params, caches, last_tok, pos, active, key)

    return step


def make_sharded_prefill_slot(mesh: Mesh, cfg: TransformerConfig,
                              cache: str = "slotted", temperature: float = 0.0,
                              weight_quant: str | None = None,
                              kv_quant: str | None = None):
    """Multi-chip fused prefill of one request into cache row `slot`.

    Runs as ONE shard_map (no GSPMD gathers): every chip computes the
    prompt forward on its local heads (Megatron TP, psum projections) —
    prefill activations are replicated across `data` — and only the data
    shard that owns `slot` writes its local cache (slotted row or paged
    pool; page-table ids are shard-local). Same signature as the
    single-host jit: (params, caches, tokens, true_len, slot, key=...)."""
    from quantizedattention_tpu.models.sharded_train import param_specs
    from quantizedattention_tpu.models.transformer import _attention, sample_token
    from quantizedattention_tpu.parallel.paged_cache import (
        PagedKVCache,
        write_prompt_paged,
    )

    specs = _maybe_quantized_specs(param_specs(cfg), weight_quant)
    cspecs = _layer_cache_specs(cfg, cache, kv_quant)
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, cspecs, P(), P(), P(), P()),
        out_specs=(P(), cspecs),
        check_vma=False,
    )
    def sharded(params, caches, tokens, true_len, slot, key):
        c0 = caches[0]
        slots_loc = (c0.lengths if hasattr(c0, "lengths") else c0.length).shape[0]
        data_idx = jax.lax.axis_index("data")
        own = (slot // slots_loc) == data_idx
        slot_loc = slot % slots_loc

        t_pad = tokens.shape[0]
        positions = jnp.arange(t_pad)
        x = embedding_lookup(params["embed"], tokens)[None]
        new_caches = []
        for layer, cache_l in zip(params["layers"], caches):
            h = rmsnorm(x, layer["ln1"])
            q = mm(h, layer["wq"]).reshape(1, t_pad, h_loc, cfg.head_dim).transpose(0, 2, 1, 3)
            k = mm(h, layer["wk"]).reshape(1, t_pad, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
            v = mm(h, layer["wv"]).reshape(1, t_pad, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
            q = rope(q, positions, cfg.rope_base)
            k = rope(k, positions, cfg.rope_base)

            write = (
                write_prompt_paged if isinstance(cache_l, PagedKVCache)
                else _cache_write_slot
            )
            cache_l = jax.lax.cond(
                own,
                lambda c: write(c, slot_loc, k[0], v[0], true_len),
                lambda c: c,
                cache_l,
            )
            o = _attention(q, k, v, cfg)  # GQA repeat ratio is shard-invariant
            o = o.transpose(0, 2, 1, 3).reshape(1, t_pad, h_loc * cfg.head_dim)
            x = x + jax.lax.psum(mm(o.astype(x.dtype), layer["wo"]), "model")
            hh = rmsnorm(x, layer["ln2"])
            x = x + jax.lax.psum(mm(jax.nn.gelu(mm(hh, layer["w1"])), layer["w2"]), "model")
            new_caches.append(cache_l)
        x = rmsnorm(x, params["final_norm"])
        logits = mm(x[0, true_len - 1], params["unembed"])
        k_s = None if sampling_temperature(temperature) == 0.0 else key
        return sample_token(logits, temperature, k_s), new_caches

    _jitted = jax.jit(sharded)

    def prefill(params, caches, tokens, true_len, slot, key=None):
        if key is None:
            key = jax.random.key(0)  # unused placeholder (greedy path)
        return _jitted(params, caches, tokens, true_len, slot, key)

    return prefill


def make_sharded_prefill_chunk(mesh: Mesh, cfg: TransformerConfig,
                               cache: str = "slotted",
                               temperature: float = 0.0,
                               weight_quant: str | None = None,
                               kv_quant: str | None = None):
    """Multi-chip CHUNKED prefill (the mesh counterpart of
    models.transformer.prefill_chunk, same keyword signature).

    Chunk activations replicate across `data` (heads shard on `model`), so
    the causal self part runs everywhere; the PREFIX lives only in the
    owning data shard's cache, so every shard computes the prefix part
    against its local row (garbage off-owner — bounded int8 values), merges
    locally, and one masked psum over `data` selects the owner's merged
    output for all shards. The owning shard alone writes the chunk."""
    from quantizedattention_tpu.models.sharded_train import param_specs
    from quantizedattention_tpu.models.transformer import sample_token
    from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
    from quantizedattention_tpu.parallel.kv_cache import write_kv_chunk
    from quantizedattention_tpu.parallel.paged4_cache import (
        Paged4KVCache,
        read_prefix_paged4,
        write_chunk_paged4,
    )
    from quantizedattention_tpu.parallel.paged_cache import (
        PagedKVCache,
        read_prefix_paged,
        write_chunk_paged,
    )
    from quantizedattention_tpu.parallel.ring import _merge_partials

    specs = _maybe_quantized_specs(param_specs(cfg), weight_quant)
    cspecs = _layer_cache_specs(cfg, cache, kv_quant)
    n_model = mesh.shape["model"]
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model

    def _build(chunk_start: int, last: bool):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(specs, cspecs, P(), P(), P(), P()),
            out_specs=(P(), cspecs),
            check_vma=False,
        )
        def sharded(params, caches, tokens, true_end, slot, key):
            c0 = caches[0]
            slots_loc = (c0.lengths if hasattr(c0, "lengths") else c0.length).shape[0]
            data_idx = jax.lax.axis_index("data")
            own = (slot // slots_loc) == data_idx
            slot_loc = slot % slots_loc

            c = tokens.shape[0]
            positions = chunk_start + jnp.arange(c)
            x = embedding_lookup(params["embed"], tokens)[None]
            new_caches = []
            for layer, cache_l in zip(params["layers"], caches):
                paged = isinstance(cache_l, (PagedKVCache, Paged4KVCache))
                h = rmsnorm(x, layer["ln1"])
                q = mm(h, layer["wq"]).reshape(1, c, h_loc, cfg.head_dim).transpose(0, 2, 1, 3)
                k = mm(h, layer["wk"]).reshape(1, c, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
                v = mm(h, layer["wv"]).reshape(1, c, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
                q = rope(q, positions, cfg.rope_base)
                k = rope(k, positions, cfg.rope_base)

                new_len = jnp.minimum(chunk_start + c, true_end)
                if paged:
                    ps = cache_l.page_size
                    cap = cache_l.page_table.shape[1] * ps
                    c_w = min(c, cap - chunk_start)
                    wfn = (write_chunk_paged4
                           if isinstance(cache_l, Paged4KVCache) else write_chunk_paged)
                    write = lambda cc, _w=wfn: _w(
                        cc, slot_loc, k[0, :, :c_w], v[0, :, :c_w],
                        chunk_start // ps, new_len)
                else:
                    c_w = min(c, cache_l.max_len - chunk_start)
                    write = lambda cc: write_kv_chunk(
                        cc, slot_loc, k[0, :, :c_w], v[0, :, :c_w],
                        chunk_start, new_len)
                cache_l = jax.lax.cond(own, write, lambda cc: cc, cache_l)

                o, lse = flash_attention_fwd(q, k, v, causal=True)  # GQA-native
                if chunk_start > 0:
                    if paged:
                        rfn = (read_prefix_paged4
                               if isinstance(cache_l, Paged4KVCache) else read_prefix_paged)
                        k_pre, v_pre = rfn(cache_l, slot_loc, chunk_start)
                        k_pre, v_pre = k_pre[None], v_pre[None]
                    else:
                        k_pre = (
                            cache_l.k_i8[slot_loc, :, :chunk_start].astype(jnp.float32)
                            * cache_l.sk[slot_loc, :, :chunk_start, None]
                        )[None]
                        v_pre = (
                            cache_l.v_i8[slot_loc, :, :chunk_start].astype(jnp.float32)
                            * cache_l.sv[slot_loc, :, :chunk_start, None]
                        )[None]
                    o2, lse2 = flash_attention_fwd(q, k_pre, v_pre, causal=False)  # GQA-native
                    o, _ = _merge_partials(o, lse, o2, lse2)
                    # select the OWNER's merged output on every data shard
                    # (off-owner prefixes were garbage); self-part-only
                    # results cancel via the mask
                    o = jax.lax.psum(
                        jnp.where(own, o, jnp.zeros_like(o)), "data"
                    )
                o = o.transpose(0, 2, 1, 3).reshape(1, c, h_loc * cfg.head_dim)
                x = x + jax.lax.psum(mm(o.astype(x.dtype), layer["wo"]), "model")
                hh = rmsnorm(x, layer["ln2"])
                x = x + jax.lax.psum(mm(jax.nn.gelu(mm(hh, layer["w1"])), layer["w2"]), "model")
                new_caches.append(cache_l)
            if not last:
                return jnp.zeros((), jnp.int32), new_caches
            x = rmsnorm(x, params["final_norm"])
            logits = mm(x[0, true_end - 1 - chunk_start], params["unembed"])
            k_s = None if sampling_temperature(temperature) == 0.0 else key
            return sample_token(logits, temperature, k_s), new_caches

        return jax.jit(sharded)

    built = {}

    def prefill(params, caches, tokens, chunk_start, true_end, slot, last,
                key=None):
        if key is None:
            key = jax.random.key(0)
        fn = built.get((chunk_start, last, tokens.shape[0]))
        if fn is None:
            fn = built[(chunk_start, last, tokens.shape[0])] = _build(chunk_start, last)
        tok, caches = fn(params, caches, tokens, jnp.int32(true_end), slot, key)
        return (tok if last else None), caches

    return prefill


def serving_shardings(mesh: Mesh, cfg: TransformerConfig, cache: str = "slotted",
                      weight_quant: str | None = None,
                      kv_quant: str | None = None):
    """(param_shardings, cache_shardings, vector_sharding) NamedSharding trees
    for placing engine state before calling the sharded decode step.
    weight_quant="int8": the param tree holds QuantizedWeight leaves
    (quantize_lm_weights), so the spec tree is its QuantizedWeight twin
    (quantize/weights.py:quantize_lm_specs)."""
    from quantizedattention_tpu.models.sharded_train import param_specs

    to_shard = lambda spec: NamedSharding(mesh, spec)
    pspecs = _maybe_quantized_specs(param_specs(cfg), weight_quant)
    pshard = jax.tree_util.tree_map(to_shard, pspecs)
    one = _layer_cache_specs(cfg, cache, kv_quant)[0]
    cshard = [
        jax.tree_util.tree_map(to_shard, one) for _ in range(cfg.n_layers)
    ]
    return pshard, cshard, to_shard(P("data"))
