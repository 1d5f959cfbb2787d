"""rCM-style consistency distillation of a DiT — trains THROUGH the JVP.

The reference's JVP kernel exists for exactly this (attention_jvp.py:1-11)
but is forward-only; here the loss contains du/dt and jax.grad works: the
attention (O, tO) pair inside dit_jvp_step carries a second-order streamed
backward (ops/jvp_bwd).

Run: python examples/distill_dit.py          (GPU, or the CPU with interpret-mode kernels)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

from quantizedattention_tpu.models import DiTConfig, dit_jvp_step, init_dit


def main():
    cfg = DiTConfig(d_model=128, n_heads=2, head_dim=64, n_layers=2, seq_len=128)
    params = init_dit(jax.random.key(0), cfg)
    opt = optax.adamw(1e-4)
    opt_state = opt.init(params)

    kx, kt = jax.random.split(jax.random.key(1))
    x = jax.random.normal(kx, (2, cfg.seq_len, cfg.d_model))
    t = jax.random.uniform(kt, (2,))

    def loss_fn(params):
        # self-consistency surrogate: (u, du/dt) along the model's own
        # velocity direction; penalize du/dt (straight flows) + keep u sane
        u, dudt = dit_jvp_step(params, x, t, cfg)
        return jnp.mean(dudt**2) + 0.1 * jnp.mean(u**2)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(5):
        params, opt_state, loss = step(params, opt_state)
        print(f"step {i}: rCM loss {float(loss):.6f}")


if __name__ == "__main__":
    from quantizedattention_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    main()
