"""Train a small LM with the corrected-bf16 attention kernels.

Single chip:      python examples/train_lm.py
Multi-chip (dev): XLA_FLAGS=--xla_force_host_platform_device_count=8 \
                  JAX_PLATFORMS=cpu python examples/train_lm.py --sharded
On a pod, call quantizedattention_tpu.parallel.initialize_multihost() first
and build the mesh with make_pod_mesh(data_dcn=<n_slices>, ...).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from quantizedattention_tpu.models import (
    TransformerConfig,
    init_transformer,
    make_sharded_train_step,
    make_train_step,
)
from quantizedattention_tpu.parallel import make_attention_mesh


def main(sharded: bool = False):
    cfg = TransformerConfig(
        vocab_size=512, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        n_layers=2, max_seq=512, attention="bf16",  # or "int8" for SageAttention3
    )
    params = init_transformer(jax.random.key(0), cfg)
    tokens = jax.random.randint(jax.random.key(1), (8, 512), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    if sharded:
        mesh = make_attention_mesh(data=1, model=2, context=4)
        # attention_sp: "auto" (default — the analytic link-bytes/FLOPs
        # model picks the predicted-best strategy at the device's published
        # peaks; it raises on a device with no peak-table row, such as the
        # CPU) | "ring" | "zigzag" (load-balanced causal ring) | "ulysses" |
        # "allgather"
        optimizer, step = make_sharded_train_step(mesh, cfg, attention_sp="zigzag")
    else:
        optimizer, step = make_train_step(cfg)
    opt_state = optimizer.init(params)

    for i in range(10):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        print(f"step {i}: loss {float(loss):.4f}")


if __name__ == "__main__":
    from quantizedattention_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    main(sharded="--sharded" in sys.argv)
