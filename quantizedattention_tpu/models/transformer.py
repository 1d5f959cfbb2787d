"""Decoder-only transformer LM on the quantized-attention kernels.

Functional (pytree params, no framework deps): RMSNorm pre-norm blocks, RoPE,
GQA-ready projections, and a choice of attention path per config:
  "bf16" — corrected-bf16 flash attention (training default)
  "int8" — SageAttention3-style int8 attention (fast fine-tuning)
Decode uses the int8 KV cache (parallel/kv_cache.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu.parallel.kv_cache import (
    append_kv,
    decode_attention,
    init_kv_cache,
    verify_decode_attention,
    write_kv_slot,
)
from quantizedattention_tpu.parallel.kv4_cache import (
    Int4KVCache,
    append_kv4,
    decode_attention_int4,
    init_kv4_cache,
    install_kv4_batched,
    read_prefix_kv4,
    verify_decode_attention_int4,
    write_kv4_chunk,
    write_kv4_slot,
)
from quantizedattention_tpu.parallel.paged4_cache import (
    Paged4KVCache,
    append_tokens_paged4,
    paged4_decode_attention,
    paged4_verify_attention,
    read_prefix_paged4,
    write_chunk_paged4,
    write_prompt_paged4,
)
from quantizedattention_tpu.parallel.paged_cache import (
    PagedKVCache,
    append_token_paged,
    append_tokens_paged,
    paged_decode_attention,
    write_prompt_paged,
)
from quantizedattention_tpu.quantize.weights import embedding_lookup, mm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    n_layers: int = 2
    mlp_ratio: int = 4
    max_seq: int = 512
    attention: str = "bf16"  # "bf16" | "int8"
    rope_base: float = 10000.0

    @property
    def mlp_dim(self) -> int:
        return self.d_model * self.mlp_ratio


def _init_linear(key, shape, scale=None):
    fan_in = shape[0] if len(shape) == 2 else int(jnp.prod(jnp.asarray(shape[:-1])))
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return jax.random.normal(key, shape, jnp.float32) * scale


def init_transformer(key, cfg: TransformerConfig):
    keys = jax.random.split(key, 2 + cfg.n_layers)
    params = {
        "embed": jax.random.normal(keys[0], (cfg.vocab_size, cfg.d_model), jnp.float32) * 0.02,
        "unembed": _init_linear(keys[1], (cfg.d_model, cfg.vocab_size)),
        "final_norm": jnp.ones((cfg.d_model,), jnp.float32),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[2 + i], 6)
        params["layers"].append(
            {
                "ln1": jnp.ones((cfg.d_model,), jnp.float32),
                "wq": _init_linear(lk[0], (cfg.d_model, cfg.n_heads * cfg.head_dim)),
                "wk": _init_linear(lk[1], (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)),
                "wv": _init_linear(lk[2], (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)),
                "wo": _init_linear(lk[3], (cfg.n_heads * cfg.head_dim, cfg.d_model)),
                "ln2": jnp.ones((cfg.d_model,), jnp.float32),
                "w1": _init_linear(lk[4], (cfg.d_model, cfg.mlp_dim)),
                "w2": _init_linear(lk[5], (cfg.mlp_dim, cfg.d_model)),
            }
        )
    return params


def rmsnorm(x, scale, eps=1e-6):
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    return (x * jax.lax.rsqrt(var + eps) * scale).astype(x.dtype)


def rope(x, positions, base: float):
    """Rotary embedding on [b, h, tokens, head_dim].

    positions: [tokens] (shared across the batch) or [b, tokens] (per-row,
    the continuous-batching decode case where every slot sits at a
    different sequence position).
    """
    d = x.shape[-1]
    freqs = base ** (-jnp.arange(0, d, 2, dtype=jnp.float32) / d)
    angles = positions[..., None].astype(jnp.float32) * freqs  # [..., t, d/2]
    if angles.ndim == 3:  # [b, t, d/2] -> broadcast over the head axis
        angles = angles[:, None]
    cos, sin = jnp.cos(angles), jnp.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = jnp.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)
    return out.reshape(x.shape).astype(x.dtype)


def _attention(q, k, v, cfg: TransformerConfig, attention_fn=None):
    """Dispatch to the configured kernel. GQA: the native kernels take
    UNREPEATED kv heads (one K/V stream per kv head — flash_fwd/int8_fwd);
    only an external `attention_fn` (oracle hooks in tests) still gets a
    repeated copy, since it may not be GQA-aware."""
    if attention_fn is not None:
        if cfg.n_kv_heads != cfg.n_heads:
            rep = cfg.n_heads // cfg.n_kv_heads
            k = jnp.repeat(k, rep, axis=1)
            v = jnp.repeat(v, rep, axis=1)
        return attention_fn(q, k, v)
    if cfg.attention == "int8":
        return sage_attention_int8(q, k, v, causal=True)
    return flash_attention_bf16(q, k, v, causal=True)


def _project_qkv(layer, x, cfg: TransformerConfig, positions):
    b, t, _ = x.shape
    q = mm(x, layer["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    k = mm(x, layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    v = mm(x, layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    q = rope(q, positions, cfg.rope_base)
    k = rope(k, positions, cfg.rope_base)
    return q, k, v


def _block(layer, x, cfg: TransformerConfig, positions, attention_fn=None):
    h = rmsnorm(x, layer["ln1"])
    q, k, v = _project_qkv(layer, h, cfg, positions)
    o = _attention(q, k, v, cfg, attention_fn)
    b, _, t, _ = o.shape
    o = o.transpose(0, 2, 1, 3).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + mm(o.astype(x.dtype), layer["wo"])
    h = rmsnorm(x, layer["ln2"])
    x = x + mm(jax.nn.gelu(mm(h, layer["w1"])), layer["w2"])
    return x


def transformer_forward(params, tokens, cfg: TransformerConfig, attention_fn=None):
    """tokens [B, T] int32 -> logits [B, T, vocab] f32."""
    positions = jnp.arange(tokens.shape[1])
    x = embedding_lookup(params["embed"], tokens)
    for layer in params["layers"]:
        x = _block(layer, x, cfg, positions, attention_fn)
    x = rmsnorm(x, params["final_norm"])
    return mm(x, params["unembed"])


def lm_loss(params, tokens, targets, cfg: TransformerConfig):
    """Mean next-token cross entropy; targets are pre-shifted labels."""
    logits = transformer_forward(params, tokens, cfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def make_train_step(cfg: TransformerConfig, optimizer=None):
    """Jitted (params, opt_state, tokens, targets) -> (params, opt_state, loss)."""
    import optax

    if optimizer is None:
        optimizer = optax.adamw(3e-4)

    @jax.jit
    def step(params, opt_state, tokens, targets):
        loss, grads = jax.value_and_grad(lm_loss)(params, tokens, targets, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return optimizer, step


# --------------------------------------------------------------------------
# KV-cache decoding (int8 cache, GQA decode)
# --------------------------------------------------------------------------

def _mlp_residual(layer, x):
    h = rmsnorm(x, layer["ln2"])
    return x + mm(jax.nn.gelu(mm(h, layer["w1"])), layer["w2"])


# -- cache-kind dispatch -------------------------------------------------------
# Four cache kinds share every serving path: slotted int8 (QuantizedKVCache),
# slotted int4 (Int4KVCache), paged int8 (PagedKVCache), paged int4
# (Paged4KVCache). isinstance branches resolve at trace time: each kind
# compiles its own step, and the int8 paths are byte-identical to before the
# int4 kinds existed.

def _cache_append(cache, k, v, active=None):
    if isinstance(cache, (PagedKVCache, Paged4KVCache)):
        act = jnp.ones((k.shape[0],), bool) if active is None else active
        fn = append_tokens_paged4 if isinstance(cache, Paged4KVCache) else append_tokens_paged
        return fn(cache, k, v, act)
    if isinstance(cache, Int4KVCache):
        return append_kv4(cache, k, v, active=active)
    return append_kv(cache, k, v, active=active)


def _cache_install_batch(cache, k, v):
    """Whole-batch prompt install into all-fresh rows (prefill_batched's
    contract: every row at length 0). int4 takes the arithmetic whole-block
    pack — append_kv4's RMW rounds exist for nonzero offsets only."""
    if isinstance(cache, Int4KVCache):
        return install_kv4_batched(cache, k, v)
    return _cache_append(cache, k, v)


def _cache_decode(q, cache):
    if isinstance(cache, PagedKVCache):
        return paged_decode_attention(q, cache)
    if isinstance(cache, Paged4KVCache):
        return paged4_decode_attention(q, cache)
    if isinstance(cache, Int4KVCache):
        return decode_attention_int4(q, cache)
    return decode_attention(q, cache)


def _cache_write_slot(cache, slot, k, v, true_len):
    if isinstance(cache, PagedKVCache):
        return write_prompt_paged(cache, slot, k, v, true_len)
    if isinstance(cache, Paged4KVCache):
        return write_prompt_paged4(cache, slot, k, v, true_len)
    if isinstance(cache, Int4KVCache):
        return write_kv4_slot(cache, slot, k, v, true_len)
    return write_kv_slot(cache, slot, k, v, true_len)


def _cache_verify(q, cache):
    if isinstance(cache, PagedKVCache):
        from quantizedattention_tpu.parallel.paged_cache import paged_verify_attention

        return paged_verify_attention(q, cache)
    if isinstance(cache, Paged4KVCache):
        return paged4_verify_attention(q, cache)
    if isinstance(cache, Int4KVCache):
        return verify_decode_attention_int4(q, cache)
    return verify_decode_attention(q, cache)


def _cache_rollback(cache, drop):
    """Shrink live token counts by `drop` [b] (speculative rejection —
    later appends overwrite the stale entries in place)."""
    if isinstance(cache, (PagedKVCache, Paged4KVCache)):
        return cache._replace(lengths=cache.lengths - drop)
    return cache._replace(length=cache.length - drop)


@dataclasses.dataclass(frozen=True)
class Sampling:
    """Static sampling spec: temperature scaling plus top-k / nucleus
    (top-p) filtering. Frozen + hashable, so it rides the existing
    `temperature` argument of every decode/prefill function as a static
    jit arg — a plain float keeps meaning "temperature only".

    top_k=0 and top_p=1.0 disable the respective filter. Filter order is
    the standard one (HF/vLLM): scale by temperature, keep the k highest
    logits, then keep the smallest set whose probability mass reaches
    top_p (always >= 1 token).
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


def sampling_temperature(temperature) -> float:
    """The float temperature of a float-or-Sampling `temperature` value."""
    return (
        temperature.temperature
        if isinstance(temperature, Sampling)
        else float(temperature)
    )


def _filter_logits(scaled, spec: Sampling):
    """Mask temperature-scaled logits outside the top-k / top-p set to -inf.

    Works on [..., vocab]; static spec, so disabled filters trace away.
    Ties at the nucleus boundary are all kept (the usual convention).
    """
    neg = jnp.array(-jnp.inf, scaled.dtype)
    if spec.top_k > 0 and spec.top_k < scaled.shape[-1]:
        kth = jax.lax.top_k(scaled, spec.top_k)[0][..., -1:]
        scaled = jnp.where(scaled < kth, neg, scaled)
    if spec.top_p < 1.0:
        srt = jnp.flip(jnp.sort(scaled, axis=-1), axis=-1)  # descending
        probs = jax.nn.softmax(srt, axis=-1)
        # keep a sorted prefix: every token whose PRECEDING cumulative mass
        # is < top_p (the first token always qualifies)
        keep = (jnp.cumsum(probs, axis=-1) - probs) < spec.top_p
        n_keep = jnp.sum(keep, axis=-1, keepdims=True)
        cut = jnp.take_along_axis(srt, n_keep - 1, axis=-1)
        scaled = jnp.where(scaled < cut, neg, scaled)
    return scaled


def sample_token(logits, temperature=0.0, key=None):
    """Greedy (temperature 0), temperature-scaled categorical, or — when
    `temperature` is a `Sampling` spec — top-k / top-p filtered sampling.
    Accepts [vocab] or [batch, vocab] logits (one draw per row)."""
    spec = (
        temperature
        if isinstance(temperature, Sampling)
        else Sampling(temperature=float(temperature))
    )
    if spec.temperature == 0.0 or key is None:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = _filter_logits(
        logits.astype(jnp.float32) / spec.temperature, spec
    )
    return jax.random.categorical(key, scaled).astype(jnp.int32)


def decode_step_batched(
    params, caches, last_tok, pos, active, cfg: TransformerConfig,
    temperature: float = 0.0, key=None,
):
    """One continuous-batching decode step over all cache slots at once.

    last_tok/pos/active: [n_slots] — every slot sits at its own sequence
    position (per-row RoPE); inactive slots ride along but never advance
    their cache (append_kv active mask). Returns (next_tok [n_slots], caches).
    """
    logits, new_caches = decode_logits_batched(params, caches, last_tok, pos, active, cfg)
    return sample_token(logits, temperature, key), new_caches


def decode_logits_batched(params, caches, last_tok, pos, active, cfg: TransformerConfig):
    """decode_step_batched up to its logits: (logits [n_slots, vocab], caches)."""
    x = embedding_lookup(params["embed"], last_tok)[:, None, :]
    positions = pos[:, None]  # [n_slots, 1]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_append(cache, k, v, active=active)
        o = _cache_decode(q[:, :, 0, :], cache)  # GQA-native
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    return mm(x[:, 0], params["unembed"]), new_caches


def verify_step_batched(
    params, caches, last_tok, draft, pos, active, cfg: TransformerConfig,
    temperature: float = 0.0, key=None,
):
    """Speculative-verification decode step: one dispatch scores the last
    accepted token plus s-1 draft tokens per slot and emits between 1 and
    s tokens per slot — token-exact with running `decode_step_batched`
    s times, because every draft token is checked against the model's own
    target (argmax, or a sampled draw) before it counts.

    GREEDY (temperature 0 / no key): the target is the argmax.

    SAMPLED (temperature > 0, optionally a `Sampling` top-k/top-p spec):
    standard rejection-sampling acceptance, specialized to a DETERMINISTIC
    drafter (the engine's n-gram lookup is a point mass q = delta_draft):
    accept draft d with prob min(1, p(d)/q(d)) = p(d), and on rejection
    resample from norm(p - min(p, q)) = p conditioned on x != d. Both
    reduce to drawing x_t from the verify distribution p_t and accepting
    while x_t == draft_t — the first mismatch's draw IS the residual
    sample, so emitted tokens are distributed exactly as plain sampling.
    Draws are keyed per (slot row, ABSOLUTE position), which makes the
    emitted stream REALIZATION-equal (not just equal in law) to a
    draft-free verify loop under the same key — the exactness oracle in
    tests/test_spec_decode.py.

    last_tok/pos/active: [n_slots] as in decode_step_batched (pos is the
    position of last_tok == the row's cache length). draft: [n_slots, s-1]
    int32 proposed continuations (from any draft source — the engine uses
    host-side n-gram prompt lookup, serve/spec.py). All s tokens' K/V are
    appended during the step; rejected tokens' entries are rolled back by
    shrinking `length` (later appends overwrite them in place).

    Returns (emitted [n_slots, s], n_emit [n_slots], caches): per row,
    emitted[:n_emit] are the accepted draft tokens followed by the model's
    own next token (the "bonus" token a plain decode step would produce) —
    n_emit >= 1 always, so a step never stalls.
    """
    n_slots, s_draft = draft.shape
    s = s_draft + 1
    tokens = jnp.concatenate([last_tok[:, None], draft], axis=1)  # [n, s]
    x = embedding_lookup(params["embed"], tokens)
    positions = pos[:, None] + jnp.arange(s)[None]  # [n, s] per-row RoPE
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_append(cache, k, v, active=active)
        o = _cache_verify(q, cache)  # [n, H, s, d], causal staircase
        o = o.transpose(0, 2, 1, 3).reshape(n_slots, s, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    logits = mm(x, params["unembed"])  # [n, s, vocab]
    if sampling_temperature(temperature) == 0.0 or key is None:
        targets = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [n, s]
    else:
        # target t predicts the token AT absolute position pos + t + 1;
        # key it by (slot row, that position) so the draw stream is a pure
        # function of where the token lands, not of how many drafts were
        # in flight when it was drawn
        out_pos = positions + 1
        row_keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(
            jnp.arange(n_slots)
        )

        def draw(row_key, lg, p):
            return sample_token(lg, temperature, jax.random.fold_in(row_key, p))

        targets = jax.vmap(
            jax.vmap(draw, in_axes=(None, 0, 0))
        )(row_keys, logits, out_pos)  # [n, s]
    # accept the longest prefix of drafts matching the model's target
    match = (draft == targets[:, :-1]).astype(jnp.int32)
    n_acc = jnp.sum(jnp.cumprod(match, axis=1), axis=1)  # [n] in [0, s-1]
    emitted = jnp.where(
        jnp.arange(s)[None] < n_acc[:, None],
        jnp.pad(draft, ((0, 0), (0, 1))),
        targets,
    )
    # roll back rejected tokens' K/V: keep last_tok + accepted drafts
    drop = s - 1 - n_acc
    if active is not None:
        drop = drop * active.astype(jnp.int32)
    new_caches = [_cache_rollback(c, drop) for c in new_caches]
    return emitted, n_acc + 1, new_caches


def decode_horizon_batched(
    params, caches, last_tok, pos, active, cfg: TransformerConfig,
    horizon: int, temperature: float = 0.0, key=None,
):
    """Run `horizon` chained decode steps in ONE jit and bank every step's
    token: returns (tokens [horizon, n_slots], caches, last_tok, pos).

    The serving engine uses this to amortize the host round-trip of fetching
    each step's tokens (EOS/budget checks happen on the host): slots that
    finish mid-horizon keep decoding into their own cache — harmless, since
    a finished slot is reset by the next prefill and over-capacity paged
    writes drop — and the host discards their surplus tokens.
    """
    bank = jnp.zeros((horizon, last_tok.shape[0]), jnp.int32)

    def step(i, state):
        bank, caches, last_tok, pos = state
        k_i = None if key is None else jax.random.fold_in(key, i)
        nxt, caches = decode_step_batched(
            params, caches, last_tok, pos, active, cfg,
            temperature=temperature, key=k_i,
        )
        return bank.at[i].set(nxt), caches, nxt, pos + active.astype(jnp.int32)

    # lax.fori_loop: ONE traced decode step regardless of horizon, so the
    # compile cost of a bank is O(1) in its size — the adaptive-horizon
    # engine (serve/engine.py) compiles buckets up to 128 steps without
    # paying 128x trace/compile (the cache pytree threads through the loop
    # carry unchanged; every shape is invariant)
    state = (bank, caches, last_tok, pos)
    state = jax.lax.fori_loop(0, horizon, step, state)
    return state


def prefill_slot(
    params, caches, tokens, true_len, slot, cfg: TransformerConfig,
    temperature: float = 0.0, key=None,
):
    """Fused prefill of one request into cache row `slot`.

    tokens: [t_pad] int32 prompt, right-padded to a bucket size so jit
    recompiles only per bucket; true_len: scalar real prompt length. Runs the
    whole prompt through the causal flash kernel in ONE pass (the reference
    has no serving path at all; `generate`'s token-by-token prefill is the
    naive fallback), installs the unrepeated K/V into the slot, and returns
    (first generated token [scalar], caches). Padding tokens sit to the
    RIGHT, so causal masking keeps them out of every real row's softmax, and
    write_kv_slot sets length = true_len so decode never sees them.
    """
    x = embedding_lookup(params["embed"], tokens)[None]  # [1, t_pad, d_model]
    positions = jnp.arange(tokens.shape[0])
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        # paged prefill: t_pad must be a multiple of the page size (the
        # engine buckets prompts accordingly); the slot is the seq id
        cache = _cache_write_slot(cache, slot, k[0], v[0], true_len)
        o = _attention(q, k, v, cfg)
        o = o.transpose(0, 2, 1, 3).reshape(1, -1, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    logits = mm(x[0, true_len - 1], params["unembed"])
    return sample_token(logits, temperature, key), new_caches


def prefill_chunk(
    params, caches, tokens, chunk_start: int, true_end, slot,
    cfg: TransformerConfig, last: bool, temperature: float = 0.0, key=None,
):
    """One chunk of a CHUNKED prefill into cache row `slot`.

    tokens: [c] int32, the prompt slice [chunk_start : chunk_start+c] (the
    last chunk right-padded; true_end = real prompt length). Chunk queries
    attend causally within the chunk (flash kernel) and non-causally to the
    already-cached prefix (dequantized int8 rows through the same flash
    kernel), merged with the ring rescale identity — so a long prompt
    prefills in O(prompt/chunk) bounded steps and the engine can interleave
    decode steps of other slots between chunks (the round-1 verdict's
    prefill-stall gap). chunk_start is static: one compile per chunk index
    per bucket, bounded by max_seq/chunk.

    Returns (token | None, caches): the sampled first token on the last
    chunk, None otherwise.
    """
    from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
    from quantizedattention_tpu.parallel.kv_cache import write_kv_chunk
    from quantizedattention_tpu.parallel.paged_cache import (
        read_prefix_paged,
        write_chunk_paged,
    )
    from quantizedattention_tpu.parallel.ring import _merge_partials

    c = tokens.shape[0]
    x = embedding_lookup(params["embed"], tokens)[None]
    positions = chunk_start + jnp.arange(c)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        paged = isinstance(cache, (PagedKVCache, Paged4KVCache))
        is4 = isinstance(cache, Paged4KVCache)
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        # row length grows chunk by chunk (never past the real prompt end),
        # so concurrent decode steps of OTHER slots only ever see written
        # positions of this row. The written slice is trimmed to capacity:
        # the last chunk is padded to full width, and an untrimmed scatter
        # would CLAMP the start and overwrite earlier positions (slotted) or
        # earlier pages (paged) — the overhang is padding only.
        new_len = jnp.minimum(chunk_start + c, true_end)
        if paged:
            ps = cache.page_size
            cap = cache.page_table.shape[1] * ps
            c_write = min(c, cap - chunk_start)
            write_chunk = write_chunk_paged4 if is4 else write_chunk_paged
            cache = write_chunk(
                cache, slot, k[0, :, :c_write], v[0, :, :c_write],
                chunk_start // ps, new_len,
            )
        else:
            c_write = min(c, cache.max_len - chunk_start)
            wchunk = (write_kv4_chunk if isinstance(cache, Int4KVCache)
                      else write_kv_chunk)
            cache = wchunk(
                cache, slot, k[0, :, :c_write], v[0, :, :c_write], chunk_start,
                new_len,
            )
        o, lse = flash_attention_fwd(q, k, v, causal=True)  # GQA-native
        if chunk_start > 0:
            # prefix part: dequantized int8 rows/pages of [0, chunk_start) —
            # the same quantized values every later decode step reads
            if paged:
                read_prefix = read_prefix_paged4 if is4 else read_prefix_paged
                k_pre, v_pre = read_prefix(cache, slot, chunk_start)
                k_pre, v_pre = k_pre[None], v_pre[None]
            elif isinstance(cache, Int4KVCache):
                k_pre, v_pre = read_prefix_kv4(cache, slot, chunk_start)
                k_pre, v_pre = k_pre[None], v_pre[None]
            else:
                k_pre = (
                    cache.k_i8[slot, :, :chunk_start].astype(jnp.float32)
                    * cache.sk[slot, :, :chunk_start, None]
                )[None]
                v_pre = (
                    cache.v_i8[slot, :, :chunk_start].astype(jnp.float32)
                    * cache.sv[slot, :, :chunk_start, None]
                )[None]
            o2, lse2 = flash_attention_fwd(q, k_pre, v_pre, causal=False)  # GQA-native
            o, lse = _merge_partials(o, lse, o2, lse2)
        o = o.transpose(0, 2, 1, 3).reshape(1, c, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    if not last:
        return None, new_caches
    x = rmsnorm(x, params["final_norm"])
    logits = mm(x[0, true_end - 1 - chunk_start], params["unembed"])
    return sample_token(logits, temperature, key), new_caches


def prefill_slots(
    params, caches, tokens, true_lens, slots, cfg: TransformerConfig,
    temperature: float = 0.0, key=None,
):
    """Fused prefill of SEVERAL requests in one pass: tokens [B, t_pad]
    (right-padded to a shared bucket), true_lens [B], slots [B] int32 cache
    rows. One jit dispatch instead of B (each dispatch carries a fixed host
    cost that adds up over an admission burst). Returns (first tokens [B],
    caches)."""
    logits, new_caches = prefill_slots_logits(params, caches, tokens, true_lens, slots, cfg)
    # sample_token handles [B, vocab] rows (categorical samples per row)
    return sample_token(logits, temperature, key), new_caches


def prefill_slots_logits(params, caches, tokens, true_lens, slots, cfg: TransformerConfig):
    """prefill_slots up to its logits: (logits at each row's last real
    token [B, vocab], caches)."""
    B, t_pad = tokens.shape
    x = embedding_lookup(params["embed"], tokens)
    positions = jnp.arange(t_pad)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        for i in range(B):
            cache = _cache_write_slot(cache, slots[i], k[i], v[i], true_lens[i])
        o = _attention(q, k, v, cfg)
        o = o.transpose(0, 2, 1, 3).reshape(B, -1, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    return mm(x[jnp.arange(B), true_lens - 1], params["unembed"]), new_caches


def prefill_batched(
    params, caches, prompt, cfg: TransformerConfig,
    temperature: float = 0.0, key=None,
):
    """Fused prefill of a same-length batch: prompt [B, T0] through the
    causal flash kernel in one pass, K/V quantize-appended to every cache
    row (all rows must be at length 0). Returns (next_tok [B], caches)."""
    positions = jnp.arange(prompt.shape[1])
    x = embedding_lookup(params["embed"], prompt)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_install_batch(cache, k, v)
        o = _attention(q, k, v, cfg)
        o = o.transpose(0, 2, 1, 3).reshape(x.shape[0], -1, cfg.n_heads * cfg.head_dim)
        x = _mlp_residual(layer, x + mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    logits = mm(x[:, -1], params["unembed"])
    return sample_token(logits, temperature, key), new_caches


def generate(
    params, prompt, cfg: TransformerConfig, max_new_tokens: int = 16,
    temperature: float = 0.0, key=None, top_k: int = 0, top_p: float = 1.0,
):
    """Decoding with the int8 KV cache: one fused prefill pass over the
    whole prompt, then batched single-token decode steps — the same numerics
    as the continuous-batching engine (serve/engine.py). Greedy by default;
    temperature > 0 (with a PRNG `key`) samples, optionally top-k / top-p
    filtered.

    prompt: [B, T0] int32; returns [B, T0 + max_new_tokens].
    """
    if top_k or top_p < 1.0:
        temperature = Sampling(sampling_temperature(temperature), top_k, top_p)
    if sampling_temperature(temperature) > 0.0 and key is None:
        raise ValueError("temperature > 0 requires a PRNG key")
    b, t0 = prompt.shape
    caches = [
        init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
        for _ in params["layers"]
    ]

    def next_key():
        nonlocal key
        if key is None or sampling_temperature(temperature) == 0.0:
            return None
        key, sub = jax.random.split(key)
        return sub

    prefill = jax.jit(prefill_batched, static_argnames=("cfg", "temperature"))
    next_tok, caches = prefill(
        params, caches, prompt, cfg, temperature=temperature, key=next_key()
    )
    decode = jax.jit(decode_step_batched, static_argnames=("cfg", "temperature"))
    tokens = prompt
    active = jnp.ones((b,), bool)
    for i in range(max_new_tokens):
        tokens = jnp.concatenate([tokens, next_tok[:, None]], axis=1)
        if i < max_new_tokens - 1:
            pos = jnp.full((b,), t0 + i, jnp.int32)
            next_tok, caches = decode(
                params, caches, next_tok, pos, active, cfg,
                temperature=temperature, key=next_key(),
            )
    return tokens
