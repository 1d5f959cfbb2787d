"""Kernel timing and the device peak table.

Times are taken on the host clock around work that ends in
`block_until_ready` (JAX returns before the device finishes). Rates are
divided by the published peaks of the device JAX reports, from one table
keyed by `device_kind`; a device that is not in the table is an error, not a
default.
"""

from __future__ import annotations

import dataclasses
import time

import jax

# Published dense peaks of one card (NVIDIA H100 SXM data sheet, no
# sparsity; the rates assume the full 700 W power limit — report the card's
# power.limit beside any share of them).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "int8_tops": 1979.0,
        "tf32_tflops": 495.0,
        "hbm_tbps": 3.35,
        "nvlink_gbps_each_way": 450.0,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peak table row for `device_kind` (default: JAX's first device)."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[device_kind]


@dataclasses.dataclass
class KernelTiming:
    seconds: float
    tflops: float
    utilization: float  # share of the device's published peak

    def __str__(self):
        return (f"{self.seconds*1e3:.3f} ms, {self.tflops:.1f} TFLOP/s "
                f"({self.utilization*100:.1f}% of peak)")


def time_seconds(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds of fn(*args), each call ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def attention_flops(batch, heads, q_tokens, kv_tokens, head_dim, causal: bool) -> float:
    """MAC-counted FLOPs of softmax attention (2 matmuls), halved if causal."""
    frac = 0.5 if causal else 1.0
    return 2 * 2 * batch * heads * q_tokens * kv_tokens * head_dim * frac


def time_attention(step_fn, q, k, v, causal: bool, dtype: str = "bf16",
                   iters: int = 10) -> KernelTiming:
    """Time an attention step (q, k, v) -> array; report TFLOP/s against
    the device's bf16 or int8 peak. Raises on a device with no table row."""
    peak_key = {"bf16": "bf16_tflops", "int8": "int8_tops"}[dtype]
    peak = device_peaks()[peak_key]
    seconds = time_seconds(jax.jit(step_fn), q, k, v, iters=iters)
    b, h, t, d = q.shape
    tflops = attention_flops(b, h, t, k.shape[2], d, causal) / seconds / 1e12
    return KernelTiming(seconds, tflops, tflops / peak)
