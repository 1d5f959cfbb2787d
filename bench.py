"""Benchmark: int8 attention throughput vs bf16 SDPA on one NVIDIA GPU.

    python bench.py

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}, "card": ...}

Headline metric (BASELINE.json north-star): int8 attention forward speedup
over the XLA bf16 SDPA anchor at BASELINE config 3's long-sequence regime
(B=4, H=16, seq=4096, d=64, causal); target >= 2.0x, so vs_baseline =
speedup / 2.0. cuDNN's fused attention is reported beside it (stderr) as
the strongest anchor the card offers.

Supporting detail (stderr): the reference's canonical shape (8, 35, 1024, 64
— attention_bf16.py:567-571), d=128, GQA, train steps, JVP, serving decode
(weight and KV-cache quantization A/Bs), the engine end to end, speculative
decoding and prefix caching; accuracy envelopes vs the fp32 oracle gate the
headline.

Every time is the median over repeated calls, each ended by
block_until_ready (JAX returns before the device finishes). Without a GPU
the script exits with code 2 and prints no result. The card's name and
power limit go to stderr (a card set below 700 W runs slower under load).
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """nvidia-smi's name and power limit, read by a child that does not
    import JAX (it reserves no device memory)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def timed(fn, *args, iters=10):
    """Median seconds of the jitted fn(*args), block_until_ready per call."""
    from quantizedattention_tpu.utils.profiling import time_seconds

    return time_seconds(jax.jit(fn), *args, iters=iters)


def bthd(x):
    return jnp.swapaxes(x, 1, 2)


def sdpa(causal, implementation="xla"):
    def step(q, k, v):
        o = jax.nn.dot_product_attention(bthd(q), bthd(k), bthd(v), is_causal=causal,
                                         implementation=implementation)
        return bthd(o)
    return step


def bench_shape(B, H, T, D, causal=True, accuracy=True):
    from quantizedattention_tpu import flash_attention_fwd, sage_attention_int8_inference
    from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
    from quantizedattention_tpu.reference import reference_attention
    from quantizedattention_tpu.utils.testing import mismatch_report

    kq, kk, kv = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(kq, (B, H, T, D), jnp.float32)
    k = jax.random.normal(kk, (B, H, T, D), jnp.float32)
    v = jax.random.normal(kv, (B, H, T, D), jnp.float32)
    q16, k16, v16 = (x.astype(jnp.bfloat16) for x in (q, k, v))

    t_sdpa = timed(sdpa(causal), q16, k16, v16)
    t_cudnn = timed(sdpa(causal, "cudnn"), q16, k16, v16)
    t_bf16 = timed(lambda a, b, c: flash_attention_fwd(a, b, c, causal=causal)[0], q16, k16, v16)
    t_int8 = timed(lambda a, b, c: int8_attention_fwd(a, b, c, causal=causal)[0], q, k, v)
    t_int8i = timed(lambda a, b, c: sage_attention_int8_inference(a, b, c, causal=causal),
                    q16, k16, v16)
    flops = 2 * 2 * B * H * T * T * D * (0.5 if causal else 1.0)

    def tf(t):
        return flops / t / 1e12

    log(f"--- shape=({B},{H},{T},{D}) causal={causal} ---")
    log(f"SDPA bf16 (XLA anchor): {t_sdpa*1e3:8.3f} ms  {tf(t_sdpa):6.1f} TFLOP/s")
    log(f"SDPA bf16 (cuDNN)     : {t_cudnn*1e3:8.3f} ms  {tf(t_cudnn):6.1f} TFLOP/s")
    log(f"bf16 corrected kernel : {t_bf16*1e3:8.3f} ms  {tf(t_bf16):6.1f} TFLOP/s  "
        f"{t_sdpa/t_bf16:.2f}x SDPA  {t_cudnn/t_bf16:.2f}x cuDNN")
    log(f"int8 train (+quant)   : {t_int8*1e3:8.3f} ms  {tf(t_int8):6.1f} TOP/s  "
        f"{t_sdpa/t_int8:.2f}x SDPA")
    log(f"int8 inference        : {t_int8i*1e3:8.3f} ms  {tf(t_int8i):6.1f} TOP/s  "
        f"{t_sdpa/t_int8i:.2f}x SDPA  {t_bf16/t_int8i:.2f}x bf16-kernel")

    ok = True
    if accuracy:
        want = reference_attention(q, k, v, causal=causal)
        rep_bf16 = mismatch_report(
            "bf16", flash_attention_fwd(q16, k16, v16, causal=causal)[0], want, atol=1e-2)
        rep_int8 = mismatch_report(
            "int8", int8_attention_fwd(q, k, v, causal=causal)[0], want, atol=5e-2)
        rep_i = mismatch_report(
            "int8-inference", sage_attention_int8_inference(q, k, v, causal=causal), want,
            atol=5e-2)
        for rep in (rep_bf16, rep_int8, rep_i):
            log(str(rep))
        ok = (rep_bf16.mismatch_rate <= 5e-5 and rep_int8.mismatch_rate <= 2e-3
              and rep_i.mismatch_rate <= 2e-3)
        if not ok:
            log("WARNING: accuracy outside envelope — speedup not claimable")
    return t_sdpa, t_bf16, min(t_int8, t_int8i), ok


def bench_gqa(B=4, H=16, HKV=4, T=4096, D=64):
    """GQA-native (unrepeated KV) vs repeat-at-boundary A/B (stderr detail)."""
    from quantizedattention_tpu import flash_attention_bf16, sage_attention_int8_inference
    from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd

    rep = H // HKV
    kq, kk, kv, kd = jax.random.split(jax.random.key(5), 4)
    q = jax.random.normal(kq, (B, H, T, D), jnp.bfloat16)
    k = jax.random.normal(kk, (B, HKV, T, D), jnp.bfloat16)
    v = jax.random.normal(kv, (B, HKV, T, D), jnp.bfloat16)
    do = jax.random.normal(kd, (B, H, T, D), jnp.float32)

    def repeated(fn):
        return lambda a, b, c: fn(a, jnp.repeat(b, rep, 1), jnp.repeat(c, rep, 1))

    def fwd(a, b, c):
        return flash_attention_fwd(a, b, c, causal=True)[0]

    def i8(a, b, c):
        return sage_attention_int8_inference(a, b, c, causal=True)

    def train(fn):
        return jax.grad(lambda a, b, c: jnp.vdot(fn(a, b, c), do), argnums=(0, 1, 2))

    def f32_attn(a, b, c):
        return flash_attention_bf16(a, b, c, causal=True)

    flops = 2 * 2 * B * H * T * T * D * 0.5
    log(f"--- GQA A/B shape=({B},{H}q/{HKV}kv,{T},{D}) causal (rep={rep}) ---")
    for name, fn, work in (("bf16 fwd", fwd, flops), ("int8 fwd", i8, flops),
                           ("bf16 f+b", train(f32_attn), 3.5 * flops)):
        rep_fn = repeated(fn) if name != "bf16 f+b" else train(repeated(f32_attn))
        t_g, t_r = timed(fn, q, k, v), timed(rep_fn, q, k, v)
        log(f"{name}  GQA-native : {t_g*1e3:8.3f} ms  {work/t_g/1e12:6.1f} TFLOP/s")
        log(f"{name}  repeated KV: {t_r*1e3:8.3f} ms  {work/t_r/1e12:6.1f} TFLOP/s"
            f"  (native {t_r/t_g:.2f}x)")


def bench_train_step(B=4, H=16, T=2048, D=64):
    """Attention fwd+bwd: XLA SDPA, cuDNN, the bf16 kernels and the int8
    kernels (stderr detail)."""
    from quantizedattention_tpu import flash_attention_bf16, sage_attention_int8

    kq, kk, kv, kd = jax.random.split(jax.random.key(1), 4)
    q = jax.random.normal(kq, (B, H, T, D), jnp.bfloat16)
    k = jax.random.normal(kk, (B, H, T, D), jnp.bfloat16)
    v = jax.random.normal(kv, (B, H, T, D), jnp.bfloat16)
    do = jax.random.normal(kd, (B, H, T, D), jnp.float32)

    def train(fn):
        return jax.grad(lambda a, b, c: jnp.vdot(fn(a, b, c).astype(jnp.float32), do),
                        argnums=(0, 1, 2))

    flops = 2 * 2 * B * H * T * T * D * 0.5 * 3.5
    t_sdpa = timed(train(sdpa(True)), q, k, v)
    t_cudnn = timed(train(sdpa(True, "cudnn")), q, k, v)
    t_ours = timed(train(lambda a, b, c: flash_attention_bf16(a, b, c, causal=True)), q, k, v)
    t_i8 = timed(train(lambda a, b, c: sage_attention_int8(a, b, c, causal=True)), q, k, v)
    log(f"--- train step (fwd+bwd) shape=({B},{H},{T},{D}) causal ---")
    log(f"XLA SDPA grad : {t_sdpa*1e3:8.3f} ms  {flops/t_sdpa/1e12:6.1f} TFLOP/s")
    log(f"cuDNN grad    : {t_cudnn*1e3:8.3f} ms  {flops/t_cudnn/1e12:6.1f} TFLOP/s")
    log(f"bf16 kernel   : {t_ours*1e3:8.3f} ms  {flops/t_ours/1e12:6.1f} TFLOP/s  "
        f"{t_sdpa/t_ours:.2f}x SDPA")
    log(f"int8 kernel   : {t_i8*1e3:8.3f} ms  {flops/t_i8/1e12:6.1f} TOP/s  "
        f"{t_sdpa/t_i8:.2f}x SDPA  {t_ours/t_i8:.2f}x bf16-kernel")
    return t_ours, t_i8


def bench_jvp(B=4, H=16, T=4096, D=64):
    """Fused (O, tO) JVP forward, exact and fast, and the transpose-path
    split (stderr detail)."""
    from quantizedattention_tpu.ops.api import attention_jvp, attention_value_and_jvp

    ks = jax.random.split(jax.random.key(3), 6)
    q, k, v, tq, tk, tv = (jax.random.normal(kk_, (B, H, T, D), jnp.float32) for kk_ in ks)
    args = (q, k, v, tq, tk, tv)
    t_pair = timed(lambda *a: attention_value_and_jvp(*a), *args)
    t_fast = timed(lambda *a: attention_value_and_jvp(*a, fast=True), *args)
    t_split = timed(lambda *a: jax.jvp(attention_jvp, a[:3], a[3:]), *args)
    base = 2 * 2 * B * H * T * T * D  # one fwd's matmul flops (non-causal)
    log(f"--- JVP (O, tO) shape=({B},{H},{T},{D}) non-causal ---")
    log(f"pair (exact f32)   : {t_pair*1e3:8.3f} ms  {3*base/t_pair/1e12:6.1f} TFLOP/s")
    log(f"pair (fast, bf16)  : {t_fast*1e3:8.3f} ms  {3*base/t_fast/1e12:6.1f} TFLOP/s")
    log(f"fwd+tangent split  : {t_split*1e3:8.3f} ms  {3.5*base/t_split/1e12:6.1f} TFLOP/s")
    return t_fast


def _build_decode_arm(n_slots=8, ctx=1024, n_layers=4, weight_quant=None,
                      kv_quant=None, d_model=1024, n_heads=16, head_dim=64):
    """Build one serving-decode arm; returns (measure() -> per-step seconds
    of a 64-step decode chain in one dispatch, cfg).

    weight_quant: None (bf16 weights), "int8" or "int4" (weight-only
    quantization, dequantized in the matmul's load by XLA). kv_quant: None
    (the int8 KV cache), "int4" (packed-nibble cache) or "int8-aligned"
    (the int8 cache at the int4 arm's 256-aligned max_seq)."""
    import functools

    from quantizedattention_tpu.models import (
        TransformerConfig, decode_step_batched, init_transformer, prefill_batched,
    )
    from quantizedattention_tpu.parallel.kv4_cache import init_kv4_cache
    from quantizedattention_tpu.parallel.kv_cache import init_kv_cache

    cfg = TransformerConfig(
        vocab_size=8192, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        head_dim=head_dim, n_layers=n_layers,
        max_seq=ctx + (256 if kv_quant else 128), attention="bf16",
    )
    params = init_transformer(jax.random.key(0), cfg)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    if weight_quant is not None:
        from quantizedattention_tpu.quantize import quantize_lm_weights

        params = quantize_lm_weights(params, bits=4 if weight_quant == "int4" else 8)
    mk = init_kv4_cache if kv_quant == "int4" else init_kv_cache
    caches = [mk(n_slots, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
              for _ in params["layers"]]
    prompt = jax.random.randint(jax.random.key(2), (n_slots, ctx), 0, cfg.vocab_size)
    tok, caches = jax.jit(prefill_batched, static_argnames="cfg")(params, caches, prompt, cfg)
    decode = functools.partial(decode_step_batched, cfg=cfg)
    active = jnp.ones((n_slots,), bool)
    n = 64

    @jax.jit
    def chain(params, t0, pos0, caches):
        def body(i, st):
            t, p, c = st
            t, c = decode(params, c, t, p, active)
            return (t, p + 1, c)
        return jax.lax.fori_loop(0, n, body, (t0, pos0, caches))[0]

    pos0 = jnp.full((n_slots,), ctx, jnp.int32)

    def measure():
        t0 = time.perf_counter()
        jax.block_until_ready(chain(params, tok, pos0, caches))
        return (time.perf_counter() - t0) / n

    return measure, cfg


def _median_spread(ts):
    """(median, relative spread) of a sample list; spread = (max-min)/med."""
    ts = sorted(ts)
    med = ts[len(ts) // 2]
    return med, (ts[-1] - ts[0]) / med if med else 0.0


def bench_decode(n_slots=8, ctx=1024, n_layers=4, trials=5, **arm_kw):
    """Single-arm serving decode step rate (stderr detail)."""
    measure, cfg = _build_decode_arm(n_slots=n_slots, ctx=ctx, n_layers=n_layers, **arm_kw)
    measure()  # compile + warm
    per_step, spread = _median_spread([measure() for _ in range(trials)])
    log(f"--- serving decode: {n_slots} slots, ctx {ctx}, {n_layers}L/{cfg.d_model}d ---")
    log(f"decode step: {per_step*1e3:7.3f} ms  ->  {n_slots/per_step:,.0f} tokens/s"
        f"  (spread ±{spread*50:.1f}%)")
    return per_step


def bench_decode_ab(arm_specs, trials=3, label=""):
    """Interleaved serving-step A/B: build every arm, time them in A/B/A/B
    rounds, report median ± spread per arm and each ratio vs the FIRST arm,
    labeled 'within noise' when the delta is inside the combined spread.
    arm_specs: list of (name, kwargs-for-_build_decode_arm)."""
    arms = []
    for name, kw in arm_specs:
        m, _cfg = _build_decode_arm(**kw)
        m()  # compile + warm
        arms.append((name, m))
    samples = {name: [] for name, _ in arms}
    for _ in range(trials):
        for name, m in arms:
            samples[name].append(m())
    log(f"--- interleaved decode A/B{': ' + label if label else ''} ({trials} rounds) ---")
    base = None
    for name, _m in arms:
        med, spread = _median_spread(samples[name])
        if base is None:
            base = (name, med, spread)
            log(f"  {name:24s} {med*1e3:8.3f} ms/step  ±{spread*50:4.1f}%  (baseline)")
            continue
        ratio = base[1] / med
        noise = (base[2] + spread) / 2
        tag = "WITHIN NOISE" if abs(ratio - 1.0) <= noise else (
            "faster" if ratio > 1 else "SLOWER")
        log(f"  {name:24s} {med*1e3:8.3f} ms/step  ±{spread*50:4.1f}%  "
            f"{ratio:5.2f}x vs {base[0]} [{tag}]")


def _lm(n_layers, max_seq):
    from quantizedattention_tpu.models import TransformerConfig, init_transformer

    cfg = TransformerConfig(
        vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        n_layers=n_layers, max_seq=max_seq, attention="bf16",
    )
    return cfg, init_transformer(jax.random.key(0), cfg)


def _serve(params, cfg, waves, **kw):
    """Run warm-up waves then one timed wave; returns (tokens, seconds, engine)."""
    from quantizedattention_tpu.serve import ServingEngine

    eng = ServingEngine(params, cfg, scheduler="native", param_dtype=jnp.bfloat16, **kw)
    *warm, timed_wave = waves
    for wave in warm:
        for prompt, n in wave:
            eng.submit(prompt, n)
        eng.run()
    rids = [eng.submit(prompt, n) for prompt, n in timed_wave]
    t0 = time.perf_counter()
    res = eng.run()
    dt = time.perf_counter() - t0
    return sum(len(r.tokens) for r in res.values()), dt, eng, [res[r] for r in rids]


def bench_engine(n_slots=8, ctx=1024, horizon=32, n_tokens=96, n_layers=4, adaptive=None):
    """Engine end-to-end tokens/s with the host-time ledger (stderr detail)."""
    import numpy as np

    cfg, params = _lm(n_layers, ctx + 256)
    rng = np.random.default_rng(0)
    wave = [(list(rng.integers(1, cfg.vocab_size, size=ctx // 4)), n_tokens)
            for _ in range(n_slots)]
    total, dt, eng, _ = _serve(params, cfg, [wave, wave], n_slots=n_slots,
                               decode_horizon=horizon, adaptive_horizon=adaptive)
    log(f"--- engine end-to-end: {n_slots} slots, ctx {ctx//4} prompt, horizon {horizon}, "
        f"{n_layers}L model ---")
    log(f"{total} tokens in {dt:.3f}s -> {total/dt:,.0f} tokens/s")
    led = eng.ledger()
    if led.get("wall_s"):
        log(f"ledger: {led['dispatches']} dispatches ({led['dispatch_s']:.3f}s) "
            f"+ {led['fetches']} fetch batches ({led['fetch_s']:.3f}s) "
            f"+ host/sched {led['other_host_s']:.3f}s = {led['wall_s']:.3f}s "
            f"for {led['tokens']} tokens")
    return total / dt


def bench_spec_decode(n_slots=8, ctx=256, n_tokens=96, n_layers=4, k=4, horizon=32):
    """Speculative decoding A/B on periodic prompts: plain horizon banks vs
    spec_decode=k (n-gram drafts + the staircase verify). Greedy and
    token-exact, so only throughput differs."""
    cfg, params = _lm(n_layers, -(-(ctx + 256) // 128) * 128)
    wave = [((list(range(100 + 16 * i, 116 + 16 * i)) * (ctx // 16 + 1))[:ctx], n_tokens)
            for i in range(n_slots)]
    tot_a, dt_a, _, _ = _serve(params, cfg, [wave, wave], n_slots=n_slots,
                               decode_horizon=horizon)
    tot_b, dt_b, eng_b, _ = _serve(params, cfg, [wave, wave], n_slots=n_slots, spec_decode=k)
    sp = eng_b.stats()["spec"]
    log(f"--- speculative decode A/B: {n_slots} slots, ctx {ctx} periodic prompt, "
        f"{n_layers}L model ---")
    log(f"plain (horizon {horizon}): {tot_a/dt_a:,.0f} tokens/s")
    log(f"spec  (k={k}):            {tot_b/dt_b:,.0f} tokens/s  "
        f"({sp['tokens_per_pass']:.2f} tokens/model-pass, {sp['accepted']} drafts accepted)")
    log(f"spec-decode speedup: {(tot_b/dt_b)/(tot_a/dt_a):.2f}x")


def bench_prefix_cache(n_slots=8, shared=768, tail=64, n_tokens=32, n_layers=4):
    """Prefix-caching A/B (paged engine): a wave sharing a long prompt
    prefix, cold (full prefills) vs warm (tail prefills over cached pages).
    Reports tokens/s and the median time to first token of the timed wave."""
    import numpy as np

    cfg, params = _lm(n_layers, shared + tail + 256)
    rng = np.random.default_rng(0)
    prefix = list(rng.integers(1, cfg.vocab_size, size=shared))

    def wave():
        return [(prefix + list(rng.integers(1, cfg.vocab_size, size=tail)), n_tokens)
                for _ in range(n_slots)]

    out = {}
    for warm in (False, True):
        total, dt, _eng, res = _serve(
            params, cfg, [wave(), wave()], n_slots=n_slots, cache="paged", page_size=128,
            prefill_chunk=256, decode_horizon=n_tokens, prefix_cache=warm)
        ttfts = sorted(r.ttft_s for r in res)
        out[warm] = (total / dt, ttfts[len(ttfts) // 2])
    (cold_tps, cold_ttft), (warm_tps, warm_ttft) = out[False], out[True]
    log(f"--- prefix-cache A/B: {n_slots} slots x ({shared} shared + {tail} tail), "
        f"{n_tokens} new tokens, {n_layers}L ---")
    log(f"cold {cold_tps:,.0f} tok/s -> warm {warm_tps:,.0f} tok/s ({warm_tps/cold_tps:.2f}x); "
        f"TTFT median cold {cold_ttft*1e3:,.1f} ms -> warm {warm_ttft*1e3:,.1f} ms")


def main():
    from quantizedattention_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform} devices only")
        sys.exit(2)
    card_line = card()
    log(f"device: {dev.device_kind} x{len(jax.devices())}; card: {card_line}")

    # BASELINE config 3's long-sequence regime — the HEADLINE — runs first
    t_sdpa, t_bf16, t_int8, ok = bench_shape(4, 16, 4096, 64, causal=True)
    speedup = t_sdpa / t_int8 if ok else 0.0
    print(json.dumps({
        "metric": "int8_attention_speedup_vs_bf16_sdpa_seq4096",
        "value": round(speedup, 4),
        "unit": "x",
        "vs_baseline": round(speedup / 2.0, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line,
    }), flush=True)

    bench_shape(8, 35, 1024, 64, causal=True)   # the reference's canonical shape
    bench_shape(8, 16, 1024, 128, causal=True)  # head_dim 128 (BASELINE config 2)
    bench_shape(4, 8, 4096, 128, causal=True)
    bench_gqa()
    bench_train_step()
    bench_train_step(T=4096)
    bench_train_step(B=2, H=8, T=8192)
    bench_train_step(B=2, H=8, T=4096, D=128)
    bench_jvp()
    bench_decode()
    bench_decode_ab([("bf16", {}), ("w8", {"weight_quant": "int8"}),
                     ("w4", {"weight_quant": "int4"})],
                    label="weights @ d_model 1024 / 4L")
    d4096 = dict(d_model=4096, n_heads=32, head_dim=128, ctx=512, n_slots=8)
    bench_decode_ab([("bf16", dict(d4096)), ("w8", dict(d4096, weight_quant="int8")),
                     ("w4", dict(d4096, weight_quant="int4"))],
                    label="weights @ d_model 4096 / 4L")
    bench_decode_ab([("kv8-aligned", {"kv_quant": "int8-aligned"}),
                     ("kv4", {"kv_quant": "int4"})], label="int4 KV @ ctx 1024")
    bench_decode_ab([("kv8-aligned", {"ctx": 4096, "kv_quant": "int8-aligned"}),
                     ("kv4", {"ctx": 4096, "kv_quant": "int4"})], label="int4 KV @ ctx 4096")
    bench_engine()
    bench_spec_decode()
    bench_decode(n_layers=12)
    bench_engine(n_layers=12)
    bench_engine(n_layers=12, adaptive=128)
    bench_prefix_cache()
    bench_shape(2, 8, 8192, 64, causal=True)


if __name__ == "__main__":
    main()
