"""Block-size sweeps with a persisted best-config cache the defaults consult.

The counterpart of the reference's tune-then-pin workflow: Helion's
`PowerOfTwoFragment(32, 256, 32)` sweep plus the recorded best RTX3080 config
left in a comment (reference: attention_int8.py:155-159,
attention_bf16.py:734-748, README.md:57-67). Here:

  * `autotune`       — forward sweep over (block_q, block_kv, num_warps,
                       num_stages);
  * `autotune_bwd`   — independent backward sweep over (block_q_bwd,
                       block_kv_bwd);
  * winners persist to JSON keyed by (kind, q_tokens, kv_tokens, head_dim,
    device kind) — and `tune.config.default_block_config` CONSULTS that
    cache, so a tuned shape is picked up by the public API on the next
    call with no plumbing. The file lives inside the checkout
    (`.tune_cache.json`, gitignored) unless QATTN_TUNE_CACHE names another.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import time

import jax

from quantizedattention_tpu.tune.config import MIN_BLOCK, BlockConfig
from quantizedattention_tpu.utils.runtime import REPO_ROOT, next_pow2

_CACHE_ENV = "QATTN_TUNE_CACHE"
_DEFAULT_CACHE = os.path.join(REPO_ROOT, ".tune_cache.json")


def _cache_path() -> str:
    return os.environ.get(_CACHE_ENV, _DEFAULT_CACHE)


def _cache_key(kind: str, q_tokens: int, kv_tokens: int, head_dim: int,
               device_kind: str) -> str:
    return f"{kind}|q{q_tokens}|kv{kv_tokens}|d{head_dim}|{device_kind}"


def _load_cache() -> dict:
    path = _cache_path()
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return {}
    return {}


@functools.lru_cache(maxsize=256)
def _cached_entry(path: str, mtime: float, key: str):
    cache = _load_cache()
    return tuple(sorted(cache[key].items())) if key in cache else None


def load_cached_config(kind: str, q_tokens: int, kv_tokens: int,
                       head_dim: int) -> BlockConfig | None:
    """Cheap (mtime-memoized) lookup of a previously tuned config."""
    path = _cache_path()
    try:
        # nanosecond mtime + size: second-resolution mtime can alias a
        # write-then-read within the same second and serve a stale memo
        st = os.stat(path)
        mtime = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    try:
        device_kind = jax.devices()[0].device_kind
    except RuntimeError:
        return None
    entry = _cached_entry(path, mtime, _cache_key(kind, q_tokens, kv_tokens, head_dim, device_kind))
    if entry is None:
        return None
    d = dict(entry)
    d = {k: v for k, v in d.items() if k in BlockConfig.__dataclass_fields__}
    return BlockConfig(**d)


def save_config(kind: str, q_tokens: int, kv_tokens: int, head_dim: int,
                config) -> None:
    path = _cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cache = _load_cache()
    entry = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
    cache[_cache_key(kind, q_tokens, kv_tokens, head_dim, jax.devices()[0].device_kind)] = entry
    with open(path, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)


def _time_one(fn, args, iters: int = 10) -> float:
    """Median seconds of one fn(*args) call, each ended by
    block_until_ready (JAX returns before the device finishes)."""
    jitted = jax.jit(fn)
    jax.block_until_ready(jitted(*args))  # compile + warm up
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(jitted(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _pow2_upto(lo: int, hi: int):
    c, out = lo, []
    while c <= hi:
        out.append(c)
        c *= 2
    return out


def autotune(
    kind: str,
    make_fn,
    args,
    q_tokens: int,
    kv_tokens: int,
    block_candidates=None,
    kv_candidates=None,
    warp_candidates=(4, 8),
    stage_candidates=(2, 3),
    iters: int = 10,
    use_cache: bool = True,
):
    """Forward sweep over (block_q, block_kv, num_warps, num_stages); pin
    the winner. `make_fn(config) -> callable(*args)` builds the kernel under
    test. Returns (best_config, best_seconds — None on cache hit).

    Tile candidates default to powers of two in [16, 128] (a Hopper block's
    shared memory and registers bound them). Candidates that fail to
    compile (shared memory or registers exceeded) are skipped, mirroring
    the reference's shared-memory-limited pinning
    (attention_bf16.py:302-307).
    """
    head_dim = jax.tree_util.tree_leaves(args)[0].shape[-1]
    if use_cache:
        cached = load_cached_config(kind, q_tokens, kv_tokens, head_dim)
        if cached is not None:
            return cached, None

    if block_candidates is None:
        block_candidates = _pow2_upto(32, min(128, next_pow2(q_tokens)))
    if kv_candidates is None:
        kv_candidates = _pow2_upto(MIN_BLOCK * 2, min(128, next_pow2(kv_tokens)))

    from quantizedattention_tpu.tune.config import _DEFAULTS

    prev = load_cached_config(kind, q_tokens, kv_tokens, head_dim) if use_cache else None
    if prev is None:
        prev = _DEFAULTS[kind].clamp(q_tokens, kv_tokens)
    best_cfg, best_t = None, float("inf")
    for bq, bkv, warps, stages in itertools.product(
        block_candidates, kv_candidates, warp_candidates, stage_candidates
    ):
        # the forward sweep keeps the backward tiles it started from
        cfg = dataclasses.replace(prev, block_q=bq, block_kv=bkv,
                                  num_warps=warps, num_stages=stages)
        try:
            t = _time_one(make_fn(cfg), args, iters=iters)
        except Exception:
            continue
        if t < best_t:
            best_cfg, best_t = cfg, t
    if best_cfg is None:
        raise RuntimeError(f"autotune({kind}): no candidate compiled")
    if use_cache:
        save_config(kind, q_tokens, kv_tokens, head_dim, best_cfg)
    return best_cfg, best_t


def autotune_bwd(
    kind: str,
    make_fn,
    args,
    q_tokens: int,
    kv_tokens: int,
    candidates=None,
    iters: int = 10,
    use_cache: bool = True,
):
    """Independent backward sweep over (block_q_bwd, block_kv_bwd).

    `make_fn(config) -> callable(*args)` should run the BACKWARD under test
    (e.g. jax.grad of the public API with this config). The winner's bwd
    blocks merge into the cached entry for (kind, shape), preserving any
    tuned forward blocks.
    """
    if kind == "int8":
        # the int8 backward's tiling is pinned to the forward's quantization
        # grain (the residual contract — ops/int8_bwd.py); sweeping bwd
        # blocks would time identical kernels and persist a noise 'winner'.
        raise ValueError(
            "int8 backward tiling is fixed by the quantization grain; "
            "sweep the forward's tiles via autotune() instead"
        )
    head_dim = jax.tree_util.tree_leaves(args)[0].shape[-1]
    if candidates is None:
        candidates = _pow2_upto(MIN_BLOCK * 2, min(128, next_pow2(min(q_tokens, kv_tokens))))

    base = load_cached_config(kind, q_tokens, kv_tokens, head_dim)
    if base is None:
        from quantizedattention_tpu.tune.config import default_block_config

        base = default_block_config(kind, q_tokens, kv_tokens)

    best_cfg, best_t = None, float("inf")
    for bq, bkv in itertools.product(candidates, candidates):
        cfg = dataclasses.replace(base, block_q_bwd=bq, block_kv_bwd=bkv)
        try:
            t = _time_one(make_fn(cfg), args, iters=iters)
        except Exception:
            continue
        if t < best_t:
            best_cfg, best_t = cfg, t
    if best_cfg is None:
        raise RuntimeError(f"autotune_bwd({kind}): no candidate compiled")
    if use_cache:
        save_config(kind, q_tokens, kv_tokens, head_dim, best_cfg)
    return best_cfg, best_t
