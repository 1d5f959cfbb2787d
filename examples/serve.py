"""Serve an LM with continuous batching (paged int8 KV cache, C++ scheduler).

python examples/serve.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from quantizedattention_tpu.models import TransformerConfig, init_transformer
from quantizedattention_tpu.serve import ServingEngine


def main():
    cfg = TransformerConfig(
        vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        n_layers=2, max_seq=512, attention="bf16",
    )
    params = init_transformer(jax.random.key(0), cfg)

    eng = ServingEngine(
        params, cfg,
        n_slots=4,                     # concurrent sequences
        cache="paged",                 # vLLM-style paged int8 KV cache
        param_dtype=jnp.bfloat16,      # bf16 serving weights
        decode_horizon=8,              # tokens per host round-trip (banks
                                       # are PIPELINED: fetch N overlaps
                                       # the execution of bank N+1)
        prefill_chunk=128,             # long prompts admit chunk by chunk,
                                       # decode steps interleave between them
        temperature=0.8, seed=0,       # sampling (0.0 = greedy)
        eos_id=2,
    )
    requests = [
        eng.submit([1, 17, 42, 100], max_new_tokens=32),
        eng.submit([5, 5, 5], max_new_tokens=16,
                   # streaming: fires per recorded token, done on the last
                   on_token=lambda rid, tok, done: print(
                       f"  stream r{rid}: {tok}{' <eos/budget>' if done else ''}")),
        eng.submit(list(range(10, 40)), max_new_tokens=24),
    ]
    results = eng.run()
    for rid in requests:
        r = results[rid]
        print(f"request {rid} [{r.finish_reason}]: {r.tokens}")
    print("stats:", eng.stats())


def main_quantized_spec():
    """The serving quantization + speculation stack in one engine:
    int8 weights (dequantized in the matmul's load), int4 KV cache (packed-nibble
    decode; a CAPACITY lever — 2x context per chip, see ARCHITECTURE §4),
    and SAMPLED speculative decoding (n-gram prompt-lookup drafts verified
    in one staircase dispatch; rejection-sampling acceptance keeps the
    output distribution exactly the plain-sampling one)."""
    cfg = TransformerConfig(
        vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        n_layers=2, max_seq=512, attention="bf16",
    )
    params = init_transformer(jax.random.key(0), cfg)
    eng = ServingEngine(
        params, cfg,
        n_slots=2,
        param_dtype=jnp.bfloat16,
        weight_quant="int8",            # 2x fewer weight bytes than bf16
        kv_quant="int4",                # 2x fewer KV bytes than the int8 cache
        spec_decode=4,                  # up to 5 tokens per model pass
        temperature=0.7, top_k=16,      # composes with sampling (round 5)
        seed=0,
    )
    rid = eng.submit([7, 8, 9] * 6, max_new_tokens=32)
    res = eng.run()
    print(f"quantized+speculative [{res[rid].finish_reason}]: {res[rid].tokens}")
    print("spec stats:", eng.stats()["spec"])


if __name__ == "__main__":
    from quantizedattention_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    main()
    main_quantized_spec()
