#!/usr/bin/env python3
"""Smoke test of the whole system on one NVIDIA GPU (or four, --four).

    python chip_smoke.py            # one card: device report, kernel parity at
                                    # real widths, LM training (bf16 + int8
                                    # attention), serving, one rCM DiT step
    python chip_smoke.py --four     # four cards: dp x tp x sp train step and a
                                    # mesh decode step, each vs one card
    python chip_smoke.py --time     # one card: kernel times vs plain XLA/cuDNN

Every compiled kernel runs as compiled for the card (no interpret mode) and
is compared with the plain fp32 reference (quantizedattention_tpu.reference,
Precision.HIGHEST). Any phase that fails or misses its bound raises: the
script then exits non-zero and prints no result. Without a GPU it exits
with code 2 before running anything.

Model: the repo's dense decoder (models/transformer.py: RMSNorm pre-norm,
RoPE, GQA, 2-matrix GELU MLP). Its widths — d_model 4096, 32 x 128 heads,
8 kv heads, MLP x4, vocab 32000, max_seq 4096 — are the widest shape the
repo has driven; they belong to no named public model. Depth is cut to 4
layers (~1.0 B parameters) and weights are random from --seed.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_report() -> list[str]:
    """nvidia-smi's name and power limit per card, read by a child process
    that does not import JAX (so it reserves no device memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# model configuration
# ---------------------------------------------------------------------------

def lm_config(attention: str = "bf16", max_seq: int = 4096):
    from quantizedattention_tpu.models import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        n_layers=4, mlp_ratio=4, max_seq=max_seq, attention=attention,
    )


def rel_err(got, want) -> float:
    """Relative L2 error, computed on the host in f64 (operands may live
    on different devices)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check(name: str, ok: bool, detail: str) -> None:
    log(f"  {'PASS' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


# ---------------------------------------------------------------------------
# phase 2: kernel parity at real widths
# ---------------------------------------------------------------------------

# Bounds, from the repo's own tests:
#  bf16 forward   mismatch rate <= 5e-5 at atol 1e-2 (tests/test_baseline_configs.py,
#                 config 1/2 forward; the reference's published envelope)
#  bf16 backward  mismatch rate <= 1.2e-4 at atol 1e-2 (test_baseline_configs.py
#                 config 2, the full-size gradient bound)
#  int8 forward   mismatch rate <= 2e-3 at atol 5e-2 (tests/test_int8_attention.py)
#  int8 backward  relative L2 error <= 0.06 per gradient (test_int8_attention.py)
#  fp32 forward / JVP (O, tO)  0 mismatches at atol 1e-2 (tests/test_jvp_attention.py)
#  decode         mismatch rate <= 2e-3 at atol 5e-2 vs the fp32 oracle
#                 (tests/test_kv_cache.py)
BF16_FWD_RATE, BF16_BWD_RATE = 5e-5, 1.2e-4
INT8_FWD_RATE, INT8_BWD_REL = 2e-3, 0.06
DECODE_RATE = 2e-3

SHAPES = [(4, 16, 4096, 64, 16), (2, 8, 4096, 128, 8), (2, 8, 4096, 128, 2)]  # (b, h, t, d, h_kv)
DECODE = (8, 8, 4, 4096, 128)  # (slots, kv heads, q heads per kv head, ctx, d)


def _qkv(key, b, h, t, d, h_kv):
    import jax

    ks = jax.random.split(key, 4)
    q = jax.random.normal(ks[0], (b, h, t, d))
    k = jax.random.normal(ks[1], (b, h_kv, t, d))
    v = jax.random.normal(ks[2], (b, h_kv, t, d))
    do = jax.random.normal(ks[3], (b, h, t, d))
    return q, k, v, do


def _reference_fns():
    import jax
    import jax.numpy as jnp

    from quantizedattention_tpu.reference import reference_attention

    def expand(k, h):
        return jnp.repeat(k, h // k.shape[1], axis=1)

    def fwd(q, k, v, causal):
        with jax.default_matmul_precision("highest"):
            return reference_attention(q, expand(k, q.shape[1]), expand(v, q.shape[1]), causal)

    def vjp(q, k, v, do, causal):
        h, h_kv = q.shape[1], k.shape[1]

        def f(q_, k_, v_):
            return reference_attention(q_, expand(k_, h), expand(v_, h), causal)

        with jax.default_matmul_precision("highest"):
            _, pull = jax.vjp(f, q, k, v)
            return pull(do)

    return jax.jit(fwd, static_argnums=3), jax.jit(vjp, static_argnums=4)


def phase_kernels(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from quantizedattention_tpu import (
        attention_value_and_jvp,
        flash_attention_bf16,
        flash_attention_fwd,
        sage_attention_int8,
    )
    from quantizedattention_tpu.parallel.kv_cache import (
        append_kv,
        decode_attention,
        init_kv_cache,
    )
    from quantizedattention_tpu.reference import reference_attention_jvp
    from quantizedattention_tpu.utils.testing import mismatch_report

    ref_fwd, ref_vjp = _reference_fns()
    key = jax.random.key(seed)
    log("phase 2: parity at real widths (kernels: Triton-route Pallas as compiled "
        "for the card; fp32 modes and decode: plain JAX through XLA; reference: "
        "fp32 jnp at Precision.HIGHEST)")
    for i, (b, h, t, d, h_kv) in enumerate(SHAPES):
        q, k, v, do = _qkv(jax.random.fold_in(key, i), b, h, t, d, h_kv)
        gqa = h_kv != h
        for causal in ((True,) if gqa else (False, True)):
            tag = f"(b={b},h={h},h_kv={h_kv},t={t},d={d},causal={causal})"
            want = ref_fwd(q, k, v, causal)
            o = jax.jit(lambda q_, k_, v_: flash_attention_bf16(q_, k_, v_, causal=causal))(q, k, v)
            rep = mismatch_report("bf16 fwd", o, want, atol=1e-2)
            check(f"bf16 fwd {tag}", rep.mismatch_rate <= BF16_FWD_RATE,
                  f"bf16 P / f32 stats vs fp32; {rep}; bound rate <= {BF16_FWD_RATE}")
            wants = ref_vjp(q, k, v, do, causal)
            grads = jax.jit(jax.grad(
                lambda q_, k_, v_: jnp.sum(flash_attention_bf16(q_, k_, v_, causal=causal) * do),
                argnums=(0, 1, 2)))(q, k, v)
            for name, g, w in zip(("dq", "dk", "dv"), grads, wants):
                rep = mismatch_report(name, g, w, atol=1e-2)
                check(f"bf16 bwd {name} {tag}", rep.mismatch_rate <= BF16_BWD_RATE,
                      f"bf16 dot operands, f32 accumulation vs fp32; {rep}; "
                      f"bound rate <= {BF16_BWD_RATE}")
            o8 = jax.jit(lambda q_, k_, v_: sage_attention_int8(q_, k_, v_, causal=causal))(q, k, v)
            rep = mismatch_report("int8 fwd", o8, want, atol=5e-2)
            check(f"int8 fwd {tag}", rep.mismatch_rate <= INT8_FWD_RATE,
                  f"int8 x int8 -> int32 QK^T and PV vs fp32; {rep}; bound rate <= {INT8_FWD_RATE}")
            g8 = jax.jit(jax.grad(
                lambda q_, k_, v_: jnp.sum(sage_attention_int8(q_, k_, v_, causal=causal) * do),
                argnums=(0, 1, 2)))(q, k, v)
            for name, g, w in zip(("dq", "dk", "dv"), g8, wants):
                err = rel_err(g, w)
                check(f"int8 bwd {name} {tag}", err <= INT8_BWD_REL,
                      f"int8 S/dP/dQ, bf16 dK/dV vs fp32; rel L2 {err:.3e}; bound <= {INT8_BWD_REL}")
            if i == 0:
                # correction="none" routes to cuDNN's fused attention
                o_n = jax.jit(lambda q_, k_, v_: flash_attention_bf16(
                    q_, k_, v_, causal=causal, correction="none"))(q, k, v)
                rep = mismatch_report("cudnn fwd", o_n, want, atol=1e-2)
                check(f"bf16 fwd correction=none (cuDNN) {tag}", rep.mismatch_rate <= BF16_FWD_RATE,
                      f"cuDNN bf16 vs fp32; {rep}; bound rate <= {BF16_FWD_RATE}")
                g_n = jax.jit(jax.grad(
                    lambda q_, k_, v_: jnp.sum(flash_attention_bf16(
                        q_, k_, v_, causal=causal, correction="none") * do),
                    argnums=(0, 1, 2)))(q, k, v)
                for name, g, w in zip(("dq", "dk", "dv"), g_n, wants):
                    rep = mismatch_report(name, g, w, atol=1e-2)
                    check(f"bf16 bwd correction=none (cuDNN) {name} {tag}",
                          rep.mismatch_rate <= BF16_BWD_RATE,
                          f"cuDNN bf16 vs fp32; {rep}; bound rate <= {BF16_BWD_RATE}")
                del o_n, g_n
            del want, wants, grads, g8, o, o8
        if not gqa:
            # fp32 forward (the JVP primal, plain JAX) and the (O, tO) pair
            # (fast: the Triton kernel; exact: plain JAX)
            want = ref_fwd(q, k, v, False)
            o32, _ = jax.jit(lambda q_, k_, v_: flash_attention_fwd(q_, k_, v_, precision="fp32"))(q, k, v)
            rep = mismatch_report("fp32 fwd", o32, want, atol=1e-2)
            check(f"fp32 fwd (b={b},h={h},t={t},d={d})", rep.mismatches == 0,
                  f"plain JAX at HIGHEST vs fp32; {rep}; bound 0 mismatches")
            tq, tk, tv = (jax.random.normal(jax.random.fold_in(key, 100 + j), x.shape)
                          for j, x in enumerate((q, k, v)))
            with jax.default_matmul_precision("highest"):
                o_w, to_w = jax.jit(lambda *a: reference_attention_jvp(a[:3], a[3:]))(q, k, v, tq, tk, tv)
            for fast in (False, True):
                o_j, to_j = jax.jit(lambda *a: attention_value_and_jvp(*a, fast=fast))(q, k, v, tq, tk, tv)
                if fast:
                    # bf16 dot operands (the rCM step's mode): allclose O at
                    # rtol=atol=2e-2 and tO at 5e-2 (tests/test_jvp_grad.py)
                    ok_o = bool(jnp.all(jnp.abs(o_j - o_w) <= 2e-2 + 2e-2 * jnp.abs(o_w)))
                    ok_t = bool(jnp.all(jnp.abs(to_j - to_w) <= 5e-2 + 5e-2 * jnp.abs(to_w)))
                    check(f"jvp fwd fast (b={b},h={h},t={t},d={d})", ok_o and ok_t,
                          f"bf16 dot operands vs fp32: O max abs "
                          f"{float(jnp.max(jnp.abs(o_j - o_w))):.3e}, tO max abs "
                          f"{float(jnp.max(jnp.abs(to_j - to_w))):.3e}; bound allclose "
                          f"O 2e-2, tO 5e-2")
                else:
                    ro = mismatch_report("O", o_j, o_w, atol=1e-2)
                    rt = mismatch_report("tO", to_j, to_w, atol=1e-2)
                    check(f"jvp fwd exact (b={b},h={h},t={t},d={d})",
                          ro.mismatches == 0 and rt.mismatches == 0,
                          f"plain JAX at HIGHEST vs fp32; {ro}; {rt}; bound 0 mismatches")
            del want, o32, o_w, to_w, o_j, to_j
        del q, k, v, do

    # decode through the slotted int8 cache: 8 slots, ctx 4096, GQA 32:8
    n_slots, h_kv, group, ctx, d = DECODE
    ks = jax.random.split(jax.random.fold_in(key, 7), 3)
    kk = jax.random.normal(ks[0], (n_slots, h_kv, ctx, d))
    vv = jax.random.normal(ks[1], (n_slots, h_kv, ctx, d))
    q = jax.random.normal(ks[2], (n_slots, h_kv * group, d))
    lengths = jnp.asarray([ctx, ctx - 196, 3 * ctx // 4, ctx // 2 + 452, ctx // 2,
                           ctx // 3, ctx // 4, 17][:n_slots], jnp.int32)
    cache = append_kv(init_kv_cache(n_slots, h_kv, ctx, d), kk, vv)._replace(length=lengths)
    o_dec = jax.jit(decode_attention)(q, cache)
    mask = jnp.arange(ctx)[None, None, :] < lengths[:, None, None]
    kr = jnp.repeat(kk, group, axis=1)
    vr = jnp.repeat(vv, group, axis=1)
    with jax.default_matmul_precision("highest"):
        s = jnp.einsum("bhd,bhtd->bht", q, kr) / jnp.sqrt(1.0 * d)
        p = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
        want = jnp.einsum("bht,bhtd->bhd", p, vr)
    rep = mismatch_report("decode", o_dec, want, atol=5e-2)
    check(f"int8 cache decode vs fp32 oracle ({n_slots} slots, ctx {ctx}, d={d}, GQA {group}:1)",
          rep.mismatch_rate <= DECODE_RATE,
          f"int8 KV, bf16 dots (XLA) vs fp32 unquantized; {rep}; bound rate <= {DECODE_RATE}")


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------

def memory_limit() -> int:
    import jax

    return jax.devices()[0].memory_stats()["bytes_limit"]


def _fits(compiled, limit: int) -> tuple[bool, int]:
    m = compiled.memory_analysis()
    need = (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes - m.alias_size_in_bytes)
    return need < 0.92 * limit, need


def phase_train(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from quantizedattention_tpu.models import init_transformer, make_train_step

    log("phase 3: LM training through make_train_step at seq 4096")
    limit = memory_limit()
    for attention in ("bf16", "int8"):
        cfg = lm_config(attention)
        params = init_transformer(jax.random.key(seed), cfg)
        n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
        optimizer, step = make_train_step(cfg)
        opt_state = optimizer.init(params)
        compiled = None
        for batch in (8, 4, 2, 1):
            tokens = jax.ShapeDtypeStruct((batch, cfg.max_seq), jnp.int32)
            cand = step.lower(params, opt_state, tokens, tokens).compile()
            ok, need = _fits(cand, limit)
            log(f"  {attention}: batch {batch} needs {need / 2**30:.2f} GiB of "
                f"{limit / 2**30:.2f} GiB -> {'fits' if ok else 'too large'}")
            if ok:
                compiled = cand
                break
        check(f"{attention} train step fits", compiled is not None, "some batch in 8/4/2/1 fits")
        log(f"  {attention}: {n_params / 1e9:.3f} B params, batch {batch}, "
            f"memory_analysis: {compiled.memory_analysis()}")
        tokens = jax.random.randint(jax.random.key(seed + 1), (batch, cfg.max_seq), 0, cfg.vocab_size)
        targets = jnp.roll(tokens, -1, axis=1)
        losses = []
        for i in range(3):
            t0 = time.perf_counter()
            params, opt_state, loss = compiled(params, opt_state, tokens, targets)
            loss = float(loss)
            losses.append(loss)
            log(f"  {attention} step {i}: loss {loss:.4f} ({time.perf_counter() - t0:.3f} s host clock)")
        check(f"{attention} losses finite", all(x == x and abs(x) < 1e9 for x in losses), f"{losses}")
        if losses[-1] >= losses[0]:
            log(f"  NOTE {attention}: loss did not fall over 3 steps ({losses})")
        del params, opt_state, compiled


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

# Serving logits bound: bf16 weights and activations with an int8 KV cache
# against the fp32 model with fp32 attention; each bf16 matmul rounds its
# operands to 2^-9 relative and the int8 cache adds per-token 1/254 steps,
# over 4 layers. Relative L2 error of the logits <= 0.05.
SERVE_LOGIT_REL = 0.05
PROMPTS = (1024, 3072)  # prompt lengths drawn uniformly from this range


def phase_serve(seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantizedattention_tpu.models import init_transformer, transformer_forward
    from quantizedattention_tpu.models.transformer import decode_logits_batched, prefill_slots_logits
    from quantizedattention_tpu.parallel.kv_cache import init_kv_cache
    from quantizedattention_tpu.reference import reference_attention
    from quantizedattention_tpu.serve import ServingEngine

    log("phase 4: serving (ServingEngine, 8 slots, bf16 weights, slotted int8 KV cache)")
    cfg = lm_config("bf16")
    params = init_transformer(jax.random.key(seed), cfg)
    eng = ServingEngine(params, cfg, n_slots=8, param_dtype=jnp.bfloat16)
    log(f"  scheduler: {type(eng.sched).__name__}")
    rs = np.random.default_rng(seed)
    lens = [int(x) for x in rs.integers(PROMPTS[0], PROMPTS[1] + 1, size=8)]
    served = [[int(x) for x in rs.integers(3, cfg.vocab_size, size=n)] for n in lens]
    for prompt in served:
        eng.submit(prompt, max_new_tokens=64)
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    n_tok = [len(r.tokens) for r in results.values()]
    log(f"  served {len(results)} requests, prompts {lens}, new tokens {n_tok}, "
        f"{wall:.2f} s host clock (compilation included)")
    check("8 requests answered", len(results) == 8 and all(n == 64 for n in n_tok), f"{n_tok}")

    # the engine's compute path on the served prompts: prefill_slots over
    # the mixed prompts right-padded to the engine's bucket (per-slot cache
    # writes, logits at each row's last real token), then one batched
    # decode step through the int8 cache at per-slot positions — against
    # the fp32 forward at HIGHEST precision, one request at a time
    p16 = eng.params
    B = len(served)
    t_pad = max(eng._pad_len(x) for x in served)
    prompts = jnp.asarray([x + [0] * (t_pad - len(x)) for x in served], jnp.int32)
    true_lens = jnp.asarray(lens, jnp.int32)
    caches = [init_kv_cache(B, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
              for _ in range(cfg.n_layers)]
    pre = jax.jit(functools.partial(prefill_slots_logits, cfg=cfg))
    logits_pre, caches = pre(p16, caches, prompts, true_lens, jnp.arange(B, dtype=jnp.int32))
    nxt = jnp.argmax(logits_pre, axis=-1).astype(jnp.int32)
    dec = jax.jit(functools.partial(decode_logits_batched, cfg=cfg))
    logits_dec, _ = dec(p16, caches, nxt, true_lens, jnp.ones((B,), bool))

    @jax.jit
    def oracle(p, toks):
        with jax.default_matmul_precision("highest"):
            return transformer_forward(
                p, toks, cfg,
                attention_fn=lambda q, k, v: reference_attention(q, k, v, causal=True))

    # one shape for all requests: prompt, its next token, zero padding
    # (causal, so the padding never reaches the compared positions)
    t_o = max(lens) + 1
    want_pre, want_dec = [], []
    for i, n in enumerate(lens):
        toks = jnp.zeros((1, t_o), jnp.int32).at[0, :n].set(prompts[i, :n]).at[0, n].set(nxt[i])
        full = oracle(params, toks)
        want_pre.append(full[0, n - 1])
        want_dec.append(full[0, n])
    e_pre = rel_err(logits_pre, jnp.stack(want_pre))
    e_dec = rel_err(logits_dec, jnp.stack(want_dec))
    check(f"prefill_slots logits vs fp32 forward (prompts {lens}, bucket {t_pad})",
          e_pre <= SERVE_LOGIT_REL,
          f"bf16 weights + flash kernel vs fp32; rel L2 {e_pre:.3e}; bound <= {SERVE_LOGIT_REL}")
    check("decode-step logits (int8 KV cache, per-slot positions) vs fp32 forward",
          e_dec <= SERVE_LOGIT_REL,
          f"bf16 weights + int8 cache decode vs fp32; rel L2 {e_dec:.3e}; "
          f"bound <= {SERVE_LOGIT_REL}")
    del eng, params, p16, caches


# ---------------------------------------------------------------------------
# phase 5: rCM step (BASELINE config 5)
# ---------------------------------------------------------------------------

def phase_rcm(seed: int) -> None:
    import jax

    from quantizedattention_tpu.models.dit import DiTConfig, init_dit, make_dit_rcm_step
    from quantizedattention_tpu.parallel import make_attention_mesh

    log("phase 5: one rCM distillation step (DiT, attention (4,16,4096,64), one-device mesh)")
    cfg = DiTConfig(d_model=1024, n_heads=16, head_dim=64, n_layers=2, seq_len=4096)
    mesh = make_attention_mesh(data=1, model=1, context=1, devices=jax.devices()[:1])
    params = init_dit(jax.random.key(seed), cfg)
    x = jax.random.normal(jax.random.key(seed + 1), (4, cfg.seq_len, cfg.d_model))
    t = jax.random.uniform(jax.random.key(seed + 2), (4,))
    opt, step = make_dit_rcm_step(mesh, cfg)
    t0 = time.perf_counter()
    _, _, loss = step(params, opt.init(params), x, t)
    loss = float(loss)
    check("rCM step loss finite", loss == loss and abs(loss) < 1e9,
          f"loss {loss:.6f} ({time.perf_counter() - t0:.2f} s host clock, compilation included)")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four(seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quantizedattention_tpu.models import (
        init_transformer,
        make_sharded_train_step,
        make_train_step,
    )
    from quantizedattention_tpu.models.transformer import decode_logits_batched, prefill_batched
    from quantizedattention_tpu.models.sharded_train import param_specs
    from quantizedattention_tpu.parallel import make_attention_mesh
    from quantizedattention_tpu.parallel.kv_cache import init_kv_cache
    from quantizedattention_tpu.serve.engine import (
        _sharded_decode_logits,
        cache_specs,
        serving_shardings,
    )

    devs = jax.devices()
    check("four cards", len(devs) == 4, f"{len(devs)} devices")
    log("four cards: dp x tp x sp train step (data=1, model=2, context=2, ring SP, seq 8192, "
        "depth cut to 2 layers)")
    cfg = dataclasses.replace(lm_config("bf16", max_seq=8192), n_layers=2)
    params = init_transformer(jax.random.key(seed), cfg)
    tokens = jax.random.randint(jax.random.key(seed + 1), (1, cfg.max_seq), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)
    # SGD at lr 1: the update is -grad, so |p_new - p_old| is the global grad norm
    sgd = optax.sgd(1.0)

    def grad_norm(new, old):
        sq = sum(jnp.sum((a.astype(jnp.float32) - b.astype(jnp.float32)) ** 2)
                 for a, b in zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(old)))
        return float(jnp.sqrt(sq))

    one = jax.device_put(params, devs[0])
    _, step1 = make_train_step(cfg, optimizer=sgd)
    new1, _, loss1 = step1(one, sgd.init(one), jax.device_put(tokens, devs[0]),
                           jax.device_put(targets, devs[0]))
    loss1, gn1 = float(loss1), grad_norm(new1, one)
    del new1, one

    mesh = make_attention_mesh(data=1, model=2, context=2)
    _, step4 = make_sharded_train_step(mesh, cfg, optimizer=sgd, attention_sp="ring")
    pshard = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), param_specs(cfg))
    p4 = jax.device_put(params, pshard)
    tok_sh = NamedSharding(mesh, P("data", "context"))
    t0 = time.perf_counter()
    new4, _, loss4 = step4(p4, sgd.init(p4), jax.device_put(tokens, tok_sh),
                           jax.device_put(targets, tok_sh))
    loss4 = float(loss4)
    gn4 = grad_norm(new4, p4)
    log(f"  one card: loss {loss1:.6f}, grad norm {gn1:.6f}; four cards: loss {loss4:.6f}, "
        f"grad norm {gn4:.6f} ({time.perf_counter() - t0:.2f} s host clock, compilation included)")
    check("sharded loss matches one card", abs(loss4 - loss1) <= 2e-2 * max(1.0, abs(loss1)),
          f"|diff| {abs(loss4 - loss1):.3e}; bound 2e-2 relative (tests/test_distributed.py)")
    check("sharded grad norm matches one card", abs(gn4 - gn1) <= 5e-2 * gn1,
          f"rel diff {abs(gn4 - gn1) / gn1:.3e}; bound 5e-2 (bf16 kernels, different sum order)")
    del new4, p4

    log("four cards: mesh decode step (data=2 x model=2) vs one card")
    dcfg = lm_config("bf16")
    dparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                     init_transformer(jax.random.key(seed + 3), dcfg))
    B, T = 8, PROMPTS[0]
    prompt = jax.random.randint(jax.random.key(seed + 4), (B, T), 3, dcfg.vocab_size)
    caches = [init_kv_cache(B, dcfg.n_kv_heads, dcfg.max_seq, dcfg.head_dim)
              for _ in range(dcfg.n_layers)]
    dp1 = jax.device_put(dparams, devs[0])
    nxt, caches = jax.jit(lambda p, c, x: prefill_batched(p, c, x, dcfg))(
        dp1, jax.device_put(caches, devs[0]), jax.device_put(prompt, devs[0]))
    pos = jnp.full((B,), T, jnp.int32)
    act = jnp.ones((B,), bool)
    want, _ = jax.jit(functools.partial(decode_logits_batched, cfg=dcfg))(
        dp1, caches, nxt, jax.device_put(pos, devs[0]), jax.device_put(act, devs[0]))
    # the per-device body of make_sharded_decode_step, up to its logits,
    # under the same shard_map layout (slots on data, heads on model)
    dmesh = make_attention_mesh(data=2, model=2, context=1)
    vec = P("data")
    cspecs = [cache_specs()] * dcfg.n_layers
    mesh_logits = jax.jit(jax.shard_map(
        functools.partial(_sharded_decode_logits, cfg=dcfg), mesh=dmesh,
        in_specs=(param_specs(dcfg), cspecs, vec, vec, vec),
        out_specs=(P("data", None), cspecs), check_vma=False))
    psh, csh, vsh = serving_shardings(dmesh, dcfg)
    got, _ = mesh_logits(jax.device_put(dparams, psh), jax.device_put(caches, csh),
                         jax.device_put(nxt, vsh), jax.device_put(pos, vsh),
                         jax.device_put(act, vsh))
    err = rel_err(got, want)
    # bf16 weights and activations: each of the 2 psums per layer rounds its
    # partial sums to bf16 (2^-9 relative) in another order than one card
    check("mesh decode logits vs one card", err <= 3e-2,
          f"rel L2 {err:.3e}; bound 3e-2 (bf16 psum order across the model axis)")


# ---------------------------------------------------------------------------
# timing: kernels vs plain XLA / cuDNN
# ---------------------------------------------------------------------------

def int8_plain(q, k, v, causal, tile=64):
    """What XLA makes of the plain int8 forward, for timing: the same
    per-tile Q/K/V quantization, int8 x int8 -> int32 einsums for S and
    P V, per-row-per-kv-tile int8 P, the [b, h, t, t] logits materialized."""
    import jax
    import jax.numpy as jnp

    b, h, t, d = q.shape
    qk_scale = 1.4426950408889634 / d ** 0.5

    def quant(x):  # [b, h, t, d] -> int8, scale per (b, h, tile) broadcast per token
        xb = x.astype(jnp.float32).reshape(b, h, t // tile, tile, d)
        sc = jnp.maximum(jnp.max(jnp.abs(xb), axis=(3, 4), keepdims=True), 1e-12) / 127.0
        return (jnp.round(xb / sc).astype(jnp.int8).reshape(b, h, t, d),
                jnp.broadcast_to(sc[..., 0], (b, h, t // tile, tile)).reshape(b, h, t))

    q8, sq = quant(q)
    k8, sk = quant(k - jnp.mean(k, axis=2, keepdims=True))
    v8, sv = quant(v)
    s = jnp.einsum("bhqd,bhkd->bhqk", q8, k8, preferred_element_type=jnp.int32)
    s = s.astype(jnp.float32) * (sq[..., :, None] * sk[..., None, :] * qk_scale)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -30000.0)
    p = jnp.exp2(s - jnp.max(s, axis=-1, keepdims=True)).reshape(b, h, t, t // tile, tile)
    pmax = jnp.maximum(jnp.max(p, axis=-1, keepdims=True), 1e-30)
    p8 = jnp.round(p / pmax * 127.0).astype(jnp.int8)
    pv = jnp.einsum("bhqnk,bhnkd->bhqnd", p8, v8.reshape(b, h, t // tile, tile, d),
                    preferred_element_type=jnp.int32).astype(jnp.float32)
    sv_t = sv.reshape(b, h, t // tile, tile)[..., 0]
    o = jnp.sum(pv * (pmax / 127.0) * sv_t[:, :, None, :, None], axis=3)
    l = jnp.sum(jnp.sum(p8.astype(jnp.float32), axis=-1) * pmax[..., 0] / 127.0, axis=-1)
    return o / l[..., None]


def int8_plain_train(q, k, v, causal):
    """Plain training twin for timing: the int8 forward above as the value,
    gradients through XLA's bf16 attention on the dequantized operands
    (a straight-through estimator — XLA cannot differentiate int8 dots)."""
    import jax
    import jax.numpy as jnp

    def bthd(x):
        return jnp.swapaxes(x, 1, 2)

    dense = bthd(jax.nn.dot_product_attention(bthd(q.astype(jnp.bfloat16)), bthd(k.astype(jnp.bfloat16)),
                                              bthd(v.astype(jnp.bfloat16)), is_causal=causal,
                                              implementation="xla")).astype(jnp.float32)
    return dense + jax.lax.stop_gradient(int8_plain(q, k, v, causal) - dense)


def int8_bwd_plain(residuals, k_mean, o, lse, do, dims, causal):
    """What XLA makes of the int8 backward, for timing: ops/int8_bwd's math
    on the forward's residuals in plain jnp — the same int8 x int8 -> int32
    einsums for S, dP and dQ (dS quantized per row per kv tile), bf16 dV and
    dK, the K-smoothing term — with the [.., t, t] intermediates
    materialized. Works in the kernels' GQA-folded row layout."""
    import jax.numpy as jnp

    from quantizedattention_tpu.ops.common import MASK_VALUE, fold_group, qk_scales, unfold_group
    from quantizedattention_tpu.ops.int8_fwd import residual_tiles

    (q8, sq), (k8, sk), (v8, sv) = residuals
    batch, head, q_tokens, kv_len, d = dims
    sm_scale, qk_scale = qk_scales(d, None)
    bh_kv, nq, rows, _ = q8.shape
    kv_head = bh_kv // batch
    block_q, block_kv = residual_tiles(residuals, batch, head)
    nkv = sk.shape[1]
    f32, i32, bf16 = jnp.float32, jnp.int32, jnp.bfloat16
    dof = fold_group(do.astype(f32), kv_head, block_q)
    di = jnp.sum(dof * fold_group(o.astype(f32), kv_head, block_q), axis=-1)
    sdo = jnp.maximum(jnp.max(jnp.abs(dof), axis=-1), 1e-12) / 127.0
    do8 = jnp.clip(jnp.round(dof / sdo[..., None]), -127, 127).astype(jnp.int8)
    lsef = fold_group(lse.astype(f32), kv_head, block_q)
    sq, sk, sv = sq.astype(f32), sk.astype(f32), sv.astype(f32)
    col_sk = jnp.repeat(sk, block_kv, axis=1)[:, None, None, :]
    col_sv = jnp.repeat(sv, block_kv, axis=1)[:, None, None, :]
    row = (jnp.arange(nq)[:, None] * block_q + jnp.arange(rows)[None, :] % block_q)[None, :, :, None]
    col = jnp.arange(k8.shape[1])[None, None, None, :]
    mask = (col < kv_len) & ((col <= row) if causal else True)
    s = jnp.einsum("bnrd,bkd->bnrk", q8, k8, preferred_element_type=i32).astype(f32)
    s = jnp.where(mask, s * (sq * qk_scale)[..., None] * col_sk, MASK_VALUE)
    p = jnp.exp2(s - lsef[..., None])
    dv = jnp.einsum("bnrk,bnrd->bkd", p.astype(bf16), dof.astype(bf16), preferred_element_type=f32)
    dp = jnp.einsum("bnrd,bkd->bnrk", do8, v8, preferred_element_type=i32).astype(f32)
    ds = p * (dp * sdo[..., None] * col_sv - di[..., None]) * sm_scale
    dk = jnp.einsum("bnrk,bnrd->bkd", (ds * sq[..., None]).astype(bf16), q8.astype(bf16),
                    preferred_element_type=f32)
    ds_t = ds.reshape(bh_kv, nq, rows, nkv, block_kv)
    s_ds = jnp.maximum(jnp.max(jnp.abs(ds_t), axis=-1), 1e-12) / 127.0
    ds8 = jnp.round(ds_t / s_ds[..., None]).astype(jnp.int8)
    dq = jnp.einsum("bnrjc,bjcd->bnrjd", ds8, k8.reshape(bh_kv, nkv, block_kv, d),
                    preferred_element_type=i32).astype(f32)
    dq = jnp.sum(dq * (s_ds * sk[:, None, None, :])[..., None], axis=3)
    dq = dq + jnp.sum(ds, axis=-1)[..., None] * k_mean.astype(f32).reshape(bh_kv, 1, 1, d)
    return (unfold_group(dq, batch, head, q_tokens),
            dk[:, :kv_len].reshape(batch, kv_head, kv_len, d),
            dv[:, :kv_len].reshape(batch, kv_head, kv_len, d))


# int8 backward tiles swept at d=128 in --time beside the default (64-row
# q tiles, 64-wide kv tiles): (block_q, block_kv); the forward's
# quantization grain sets the backward's tiles
INT8_BWD_SWEEP = [(32, 64), (64, 32), (32, 32)]


def phase_time(seed: int, out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from quantizedattention_tpu import (
        attention_value_and_jvp,
        flash_attention_bf16,
        sage_attention_int8,
    )
    from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
    from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
    from quantizedattention_tpu.tune.config import BlockConfig
    from quantizedattention_tpu.utils.profiling import time_seconds

    def bthd(x):
        return jnp.swapaxes(x, 1, 2)

    def sdpa(impl, causal):
        def f(q, k, v):
            return bthd(jax.nn.dot_product_attention(bthd(q), bthd(k), bthd(v),
                                                     is_causal=causal, implementation=impl))
        return f

    rows, failed = [], []
    key = jax.random.key(seed)

    def record(name, shape, fn, *args, iters=20, may_refuse=False):
        """Time fn; a plain/cuDNN route or a swept launch shape may refuse
        a shape (recorded as such); a default kernel that fails is a fault."""
        try:
            sec = time_seconds(fn, *args, iters=iters)
            rows.append({"kernel": name, "shape": shape, "ms": sec * 1e3})
            log(f"  {name:32s} {shape}: {sec * 1e3:.4f}")
        except Exception as e:
            rows.append({"kernel": name, "shape": shape, "error": repr(e)[:300]})
            refused = may_refuse or "triton" not in name
            log(f"  {name:32s} {shape}: {'refused' if refused else 'FAILED'} "
                f"({type(e).__name__}: {str(e)[:160]})")
            if not refused:
                failed.append(f"{name} {shape}")

    log("timing: median of 20 calls, each ended by block_until_ready (ms)")
    for i, (b, h, t, d, h_kv) in enumerate(SHAPES):
        q, k, v, do = _qkv(jax.random.fold_in(key, i), b, h, t, d, h_kv)
        q16, k16, v16 = (x.astype(jnp.bfloat16) for x in (q, k, v))
        k_mean = jnp.mean(k, axis=-2, keepdims=True)
        dims = (b, h, t, t, d)

        def train(fn):
            return jax.jit(jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_).astype(jnp.float32) * do),
                                    argnums=(0, 1, 2)))

        for causal in (False, True):
            shape = f"({b},{h},{t},{d}) h_kv={h_kv} causal={causal}"
            cands = {
                "bf16 fwd triton": jax.jit(lambda a, b_, c: flash_attention_bf16(a, b_, c, causal=causal)),
                "bf16 fwd xla": jax.jit(sdpa("xla", causal)),
                "bf16 fwd cudnn": jax.jit(sdpa("cudnn", causal)),
                "bf16 fwd+bwd triton": train(lambda a, b_, c: flash_attention_bf16(a, b_, c, causal=causal)),
                "bf16 fwd+bwd xla": train(sdpa("xla", causal)),
                "bf16 fwd+bwd cudnn": train(sdpa("cudnn", causal)),
                "int8 fwd triton": jax.jit(lambda a, b_, c: sage_attention_int8(a, b_, c, causal=causal)),
                "int8 fwd+bwd triton": train(lambda a, b_, c: sage_attention_int8(a, b_, c, causal=causal)),
            }
            if h == h_kv:
                cands["int8 fwd xla"] = jax.jit(lambda a, b_, c: int8_plain(a, b_, c, causal))
                cands["int8 fwd+bwd xla"] = train(lambda a, b_, c: int8_plain_train(a, b_, c, causal))
            for name, fn in cands.items():
                record(name, shape, fn, q16, k16, v16)

            # the int8 backward alone, kernel vs its plain twin, on the
            # same forward residuals
            for launch in [None] + (INT8_BWD_SWEEP if d > 64 else []):
                cfg = None if launch is None else BlockConfig(block_q=launch[0], block_kv=launch[1])
                o, lse, res = jax.jit(lambda a, b_, c: int8_attention_fwd(
                    a, b_, c, causal=causal, config=cfg, k_sub=k_mean))(q, k, v)
                kern = jax.jit(lambda r, o_, l_, g: int8_attention_bwd(
                    r, k_mean, o_, l_, g, dims, causal=causal, config=cfg))
                tag = "" if launch is None else " bq={} bkv={}".format(*launch)
                record("int8 bwd triton" + tag, shape, kern, res, o, lse, do,
                       may_refuse=launch is not None)
                if launch is None:
                    plain = jax.jit(lambda r, o_, l_, g: int8_bwd_plain(r, k_mean, o_, l_, g, dims, causal))
                    err = max(rel_err(x, y) for x, y in zip(kern(res, o, lse, do), plain(res, o, lse, do)))
                    log(f"  int8 bwd plain twin vs kernel {shape}: max rel L2 {err:.3e}")
                    record("int8 bwd xla", shape, plain, res, o, lse, do)
                del o, lse, res
        if h == h_kv:
            tq, tk, tv = (x * 0.5 for x in (q16, k16, v16))
            jv = jax.jit(lambda *a: attention_value_and_jvp(*a, fast=True))
            xla = jax.jit(lambda *a: jax.jvp(sdpa("xla", False), a[:3], a[3:]))
            shape = f"({b},{h},{t},{d}) non-causal"
            for name, fn in (("jvp fwd fast triton", jv), ("jvp fwd fast xla", xla)):
                record(name, shape, fn, q16, k16, v16, tq, tk, tv, iters=10)
        del q, k, v, q16, k16, v16

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"cards": card_report(), "rows": rows}, f, indent=1)
    log(f"  wrote {out_path}")
    check("every default kernel timed", not failed, f"failed: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="the four-card path only")
    ap.add_argument("--time", action="store_true", help="kernel timing vs XLA/cuDNN only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-out", default=os.path.join(HERE, "chiprun_out", "kernel_times.json"))
    args = ap.parse_args()

    from quantizedattention_tpu.utils.runtime import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices only", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log("phase 1: device report")
    log(f"  jax {jax.__version__}; devices {devices}; device_kind {devices[0].device_kind}")
    log(f"  compile cache: {cache_dir}")
    for line in card_report():
        log(f"  nvidia-smi: {line}")

    if args.four:
        phase_four(args.seed)
    elif args.time:
        phase_time(args.seed, args.time_out)
    else:
        for phase in (phase_kernels, phase_train, phase_serve, phase_rcm):
            t0 = time.perf_counter()
            phase(args.seed)
            log(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(", ".join(card_report()))
    print(json.dumps({"ok": True, "device": {"platform": devices[0].platform,
                                             "kind": devices[0].device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
