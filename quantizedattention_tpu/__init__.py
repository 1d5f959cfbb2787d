"""quantizedattention_tpu — a quantized-attention framework in JAX.

Built from scratch in JAX/Pallas with the capabilities of
selau642/QuantizedAttention (Helion→Triton CUDA kernels): Triton-route
Pallas kernels for NVIDIA Hopper, jax.custom_vjp / custom_jvp AD
integration, and a shard_map distribution layer the reference lacks.

Public surface:
  flash_attention_bf16(q, k, v, causal)   corrected-bf16 fwd / fp32 bwd
  sage_attention_int8(q, k, v)            int8 fwd + int8 bwd (fine-tuning)
  attention_jvp(q, k, v)                  fwd-mode AD + reverse via transpose
  attention_value_and_jvp(q,k,v,tq,tk,tv) (O, tO) pair with second-order bwd
plus kernel-level entry points in ops/, quantization numerics in quantize/,
fp32 oracles in reference/, block-size tuning in tune/, and multi-chip
sharding (head-TP, ring attention, quantized KV cache) in parallel/.
"""

__version__ = "0.1.0"

from quantizedattention_tpu.ops import (
    flash_attention_bf16,
    sage_attention_int8,
    sage_attention_int8_inference,
    attention_jvp,
    attention_value_and_jvp,
    flash_attention_fwd,
    flash_attention_bwd,
    int8_attention_fwd,
    int8_attention_bwd,
    attention_jvp_fwd,
)
from quantizedattention_tpu.tune import BlockConfig, default_block_config

__all__ = [
    "flash_attention_bf16",
    "sage_attention_int8",
    "sage_attention_int8_inference",
    "attention_jvp",
    "attention_value_and_jvp",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "int8_attention_fwd",
    "int8_attention_bwd",
    "attention_jvp_fwd",
    "BlockConfig",
    "default_block_config",
]
