"""The five BASELINE.json benchmark configs as tests.

Configs 1 (CPU-runnable bf16 fwd) and the small-stability loop run anywhere;
the large-sequence configs (2, 3, 5) are full-size and carry the `gpu`
marker: they skip on the CPU, and chip_smoke.py's kernel-parity phase runs
the same checks on the card at the same or larger widths.
"""

import jax
import jax.numpy as jnp
import pytest

from quantizedattention_tpu import flash_attention_fwd, int8_attention_fwd
from quantizedattention_tpu.reference import reference_attention, reference_attention_jvp
from quantizedattention_tpu.utils.testing import mismatch_report
from tests.conftest import make_qkv


def test_config1_bf16_fwd_single_head_cpu(rng):
    """Config 1: bf16 corrected fwd, single head, seq=512 d=64 vs fp32 oracle
    — explicitly CPU-runnable."""
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=512)
    o, _ = flash_attention_fwd(q, k, v)
    rep = mismatch_report("config1", o, reference_attention(q, k, v), atol=1e-2)
    assert rep.mismatch_rate <= 5e-5, rep


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_config2_bf16_fwd_bwd_causal_2048(rng, head_dim):
    """Config 2: bf16 fwd+bwd, causal, B=4 H=16 seq=2048 d=64/128."""
    from quantizedattention_tpu import flash_attention_bf16
    from quantizedattention_tpu.reference import reference_attention_vjp

    q, k, v, do = make_qkv(rng, batch=4, head=16, q_tokens=2048, head_dim=head_dim)
    o = flash_attention_bf16(q, k, v, causal=True)
    rep = mismatch_report("config2 fwd", o, reference_attention(q, k, v, causal=True), atol=1e-2)
    assert rep.mismatch_rate <= 5e-5, rep

    dq, dk, dv = jax.grad(
        lambda q_, k_, v_: jnp.sum(flash_attention_bf16(q_, k_, v_, causal=True) * do),
        argnums=(0, 1, 2),
    )(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=True)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(nm, g, w, atol=1e-2)
        assert rep.mismatch_rate <= 1.2e-4, rep


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [2048, 8192])
def test_config3_int8_fwd_long_seq(rng, seq):
    """Config 3: int8 fwd with per-block quant at seq 2048–8192."""
    q, k, v, _ = make_qkv(rng, batch=1, head=4, q_tokens=seq)
    o, _, _ = int8_attention_fwd(q, k, v)
    rep = mismatch_report(f"config3 seq={seq}", o, reference_attention(q, k, v), atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep


def test_config4_int8_finetune_grad_stability(rng):
    """Config 4: int8 fwd+bwd fine-tune loop — gradient norms must track the
    bf16 baseline (no divergence) while the loss decreases."""
    from quantizedattention_tpu.models import (
        TransformerConfig,
        init_transformer,
        lm_loss,
        make_train_step,
    )

    def run(attention):
        cfg = TransformerConfig(
            vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
            n_layers=2, max_seq=128, attention=attention,
        )
        params = init_transformer(jax.random.key(0), cfg)
        tokens = jax.random.randint(jax.random.key(1), (2, 128), 0, cfg.vocab_size)
        targets = jnp.roll(tokens, -1, axis=1)
        import optax

        optimizer, step = make_train_step(cfg)
        opt_state = optimizer.init(params)
        norms, losses = [], []
        grad_fn = jax.jit(jax.grad(lambda p: lm_loss(p, tokens, targets, cfg)))
        for _ in range(10):
            grads = grad_fn(params)
            norms.append(float(optax.global_norm(grads)))
            params, opt_state, loss = step(params, opt_state, tokens, targets)
            losses.append(float(loss))
        return norms, losses

    n_bf16, l_bf16 = run("bf16")
    n_int8, l_int8 = run("int8")
    assert l_int8[-1] < l_int8[0], l_int8
    # int8 grad norms stay within 2x of the bf16 trajectory at every step
    for a, b in zip(n_int8, n_bf16):
        assert a == a and a < 2.0 * b + 1e-3, (n_int8, n_bf16)


@pytest.mark.gpu
def test_config5_jvp_dit_seq4096(rng):
    """Config 5: JVP attention (tangent-O) at seq=4096, fwd-mode AD."""
    from quantizedattention_tpu import attention_jvp_fwd

    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=4096)
    k1, k2, k3 = jax.random.split(jax.random.key(11), 3)
    tq = jax.random.normal(k1, q.shape)
    tk = jax.random.normal(k2, k.shape)
    tv = jax.random.normal(k3, v.shape)
    o, to, _, _ = attention_jvp_fwd(q, k, v, tq, tk, tv)
    o_w, to_w = reference_attention_jvp((q, k, v), (tq, tk, tv))
    assert mismatch_report("O", o, o_w, atol=1e-2).mismatches == 0
    assert mismatch_report("tO", to, to_w, atol=1e-2).mismatches == 0
