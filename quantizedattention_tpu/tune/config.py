"""Per-kernel block-size configuration for the Triton-route kernels.

The counterpart of the reference's tunable Helion config:
`hl.register_tunable("Bq"/"Bkv", PowerOfTwoFragment(32, 256, 32))` and pinned
`helion.Config(block_sizes=...)` (reference: attention_int8.py:155-159,
attention_bf16.py:299-308, README.md:57-67). Triton wants power-of-two
tiles, and a Hopper block has at most 227 KB of shared memory and 255
registers a thread, so tiles are small (16..256) and the number of warps
and software-pipeline stages ride with them.

JAX block sizes must be static at trace time: a BlockConfig is fixed
*before* jit/custom_vjp tracing and becomes part of the residual contract
between forward and backward (the int8 backward tiles at the forward's
quantization grain).
"""

from __future__ import annotations

import dataclasses

from quantizedattention_tpu.utils.runtime import next_pow2

# Smallest tile edge: Triton's dot wants every dimension of its right
# operand to be at least 16.
MIN_BLOCK = 16
# Upper bound on the rows one program carries (GQA folds the whole q group
# of a kv head into the rows of its q tile): the f32 accumulator, the
# [rows, block_kv] logits and the softmax stats live in registers.
MAX_ROWS = 128
# Backward passes pipeline more tiles per loop step (q, dO, lse, D and for
# int8 two dO copies), so their stages are fixed at 2.
BWD_STAGES = 2
# The int8 backward runs 4 warps whatever the forward takes: at d=128 its
# 64-row tiles ran 30-35% faster with 4 warps than with the forward's 8
# (H100 sweep, PERF.md).
INT8_BWD_WARPS = 4


def max_rows(head_dim: int) -> int:
    """Row cap of a q tile: at d=128 a 128-row tile of the int8 backward
    asked for 249,856 bytes of shared memory, over a Hopper block's 232,448
    (H100, first chip run of this port), so d > 64 caps rows at 64 for the
    kernels that keep q tiles in flight across a loop (the backwards, and
    the int8 family whose q grain the backward inherits)."""
    return MAX_ROWS if head_dim <= 64 else MAX_ROWS // 2


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile sizes and launch shape for one attention kernel family.

    block_q / block_kv: forward tiles along the q / kv token axes (the kv
    loop runs inside the program). block_q_bwd / block_kv_bwd: backward
    tiles (the dKV pass loops q inside a kv tile, the dQ pass loops kv
    inside a q tile). num_warps / num_stages: Triton launch parameters.
    """

    block_q: int = 64
    block_kv: int = 64
    block_q_bwd: int = 64
    block_kv_bwd: int = 64
    num_warps: int = 4
    num_stages: int = 2

    def __post_init__(self):
        for name in ("block_q", "block_kv", "block_q_bwd", "block_kv_bwd"):
            val = getattr(self, name)
            if not _is_pow2(val) or val < MIN_BLOCK:
                raise ValueError(f"{name}={val} must be a power of two >= {MIN_BLOCK}")
        if self.num_warps not in (1, 2, 4, 8, 16):
            raise ValueError(f"num_warps={self.num_warps} must be 1, 2, 4, 8 or 16")
        if self.num_stages < 1:
            raise ValueError("num_stages must be >= 1")

    def clamp(self, q_tokens: int, kv_tokens: int) -> "BlockConfig":
        """Shrink tiles to short sequences (never below MIN_BLOCK). Idempotent."""

        def fit(block: int, tokens: int) -> int:
            return max(MIN_BLOCK, min(block, next_pow2(tokens)))

        return dataclasses.replace(
            self,
            block_q=fit(self.block_q, q_tokens),
            block_kv=fit(self.block_kv, kv_tokens),
            block_q_bwd=fit(self.block_q_bwd, q_tokens),
            block_kv_bwd=fit(self.block_kv_bwd, kv_tokens),
        )

    def for_group(self, rep: int, rows: int = MAX_ROWS) -> "BlockConfig":
        """Shrink the q tiles so a GQA group folded into the rows of a q
        tile stays within `rows`: next_pow2(rep) * block_q <= rows, never
        below MIN_BLOCK. Deterministic and idempotent, so forward, backward
        and the int8 quantization grain all agree."""
        group = next_pow2(rep)
        cap = max(MIN_BLOCK, rows // group)
        return dataclasses.replace(
            self,
            block_q=min(self.block_q, cap),
            block_q_bwd=min(self.block_q_bwd, cap),
        )


# Pinned defaults per kernel family (not yet tuned on H100: the shapes of
# the Triton FlashAttention tutorial for Hopper — 128 q rows, 64-wide kv
# tiles, 3 pipeline stages in the forward; re-sweep with tune.autotune).
# The JVP kernel carries six accumulators, so its tiles stay small.
_DEFAULTS = {
    "bf16": BlockConfig(block_q=128, block_kv=64, block_q_bwd=64, block_kv_bwd=64,
                        num_warps=4, num_stages=3),
    "int8": BlockConfig(block_q=128, block_kv=64, block_q_bwd=64, block_kv_bwd=64,
                        num_warps=4, num_stages=3),
    "jvp": BlockConfig(block_q=64, block_kv=32, num_warps=4, num_stages=2),
}


def default_block_config(
    kind: str, q_tokens: int, kv_tokens: int, head_dim: int | None = None
) -> BlockConfig:
    """Pinned defaults, overridden by the autotune JSON cache when a tuned
    entry exists for (kind, q_tokens, kv_tokens, head_dim) on this device
    kind (the reference pins tuned configs in source,
    attention_bf16.py:734-748; here the pin is the persisted cache).
    d=128 doubles the per-row register footprint, so the forward takes 8
    warps there."""
    if head_dim is not None:
        from quantizedattention_tpu.tune.autotune import load_cached_config

        tuned = load_cached_config(kind, q_tokens, kv_tokens, head_dim)
        if tuned is not None:
            return tuned.clamp(q_tokens, kv_tokens)
    cfg = _DEFAULTS[kind]
    if head_dim is not None and head_dim > 64 and kind in ("bf16", "int8"):
        cfg = dataclasses.replace(cfg, num_warps=8)
    return cfg.clamp(q_tokens, kv_tokens)
