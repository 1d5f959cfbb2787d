"""Triton-route Pallas kernels + jax.custom_vjp / custom_jvp / custom_transpose AD.

The counterpart of the reference's five @helion.kernel functions and their
torch.autograd.Function wrappers (SURVEY.md §1 L2+L3), plus two plain-JAX
paths with no reference counterpart (the tangent-only forward and the
second-order backward behind reverse-mode JVP training):

  flash_attention_fwd    <- helion_atten_bf16_fwd_training   (attention_bf16.py:107)
  flash_attention_bwd    <- helion_flash_atten_2_algo_4_bwd  (attention_bf16.py:299)
  int8_attention_fwd     <- helion_atten_int8_hl_dot_fwd     (attention_int8.py:97)
  int8_attention_bwd     <- helion_atten_int8_hl_dot_bwd     (attention_int8.py:264)
  attention_jvp_fwd      <- helion_attention_jvp_forward_fp32 (attention_jvp.py:24)

Public API (the analogue of flash_atten_2_bf16 / sage_attention_3_int8):

  flash_attention_bf16(q, k, v, causal=...)   — custom_vjp, bf16 fwd / fp32 bwd
  sage_attention_int8(q, k, v, ...)           — custom_vjp, int8 fwd + int8 bwd
  attention_jvp(q, k, v, ...)                 — custom_jvp, fwd-mode tangent-O
                                                + reverse mode via transpose
  attention_value_and_jvp(q,k,v,tq,tk,tv)     — custom_vjp pair (O, tO) with a
                                                second-order streamed backward
"""

from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu.ops.jvp_fwd import attention_jvp_fwd
from quantizedattention_tpu.ops.jvp_bwd import attention_jvp_bwd
from quantizedattention_tpu.ops.jvp_tangent import attention_tangent_fwd
from quantizedattention_tpu.ops.api import (
    flash_attention_bf16,
    sage_attention_int8,
    sage_attention_int8_inference,
    attention_jvp,
    attention_value_and_jvp,
)

__all__ = [
    "flash_attention_fwd",
    "flash_attention_bwd",
    "int8_attention_fwd",
    "int8_attention_bwd",
    "attention_jvp_fwd",
    "attention_jvp_bwd",
    "attention_tangent_fwd",
    "flash_attention_bf16",
    "sage_attention_int8",
    "sage_attention_int8_inference",
    "attention_jvp",
    "attention_value_and_jvp",
]
