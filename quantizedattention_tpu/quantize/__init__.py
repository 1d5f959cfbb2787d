"""Numerics core: int8 quantization, K-smoothing, and the bf16 max-amplification rule.

Pure-jnp building blocks shared by the attention ops, the oracles, and the tests.
"""

from quantizedattention_tpu.quantize.int8 import (
    absmax_scale,
    quantize_int8,
    dequantize_int8,
    quantize_int8_blocks,
)
from quantizedattention_tpu.quantize.smoothing import k_smooth, K_SMOOTH_AXIS_TOKENS
from quantizedattention_tpu.quantize.bf16_correction import (
    BETA,
    APPROX_MAX_TOL,
    amplify_tied_max,
)
from quantizedattention_tpu.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_weight,
    quantize_weight_int4,
    quantize_lm_weights,
    mm,
    embedding_lookup,
)

__all__ = [
    "absmax_scale",
    "quantize_int8",
    "dequantize_int8",
    "quantize_int8_blocks",
    "k_smooth",
    "K_SMOOTH_AXIS_TOKENS",
    "BETA",
    "APPROX_MAX_TOL",
    "amplify_tied_max",
    "QuantizedWeight",
    "QuantizedWeight4",
    "quantize_weight",
    "quantize_weight_int4",
    "quantize_lm_weights",
    "mm",
    "embedding_lookup",
]
