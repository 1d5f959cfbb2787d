"""Analytic link-bytes / FLOPs scaling model for the SP attention variants.

Exact per-device byte and FLOP counts per training step, as closed-form
functions of (b, h, h_kv, t_local, d, n), for every SP strategy the library
ships, combined with per-device rates into predicted step times. The rates
come from one table of published device peaks (utils/profiling.DEVICE_PEAKS,
keyed by device_kind); a device that is not in the table has no rates and
the model raises rather than guess. Peaks are upper bounds, so the model
ranks strategies; it does not predict absolute step times.

Byte counts are derived from the actual collectives each implementation
issues (cited per function); FLOP counts are matmul FLOPs (2*M*N*K per dot).
The model captures two first-order effects:

  * CAUSAL LOAD IMBALANCE: ring and all-gather SP keep each rank's q shard
    fixed, so rank i computes ~(i + 1/2) live hops of work — the step is
    bound by the LAST rank (~n - 1/2 hops), and causal masking halves
    energy but NOT wall-clock. Ulysses re-shards by head (full sequence per
    rank) and the zigzag ring stripes chunk pairs (parallel/zigzag.py) —
    both keep causal work balanced.
  * OVERLAP STRUCTURE: the ring issues its ppermute before each hop's
    kernel (parallel/ring.py:12), so exposed time is max(compute, comm)
    per hop; all-gather/Ulysses block on their collectives up front
    (exposed = comm + compute), unless XLA finds overlap.

The cards of one host are joined all to all (NVLink through NVSwitch), so
every collective moves its bytes at the per-card link rate, whatever the
pairing. Per-hop and per-collective latencies are assumptions (not
measured), overridable per call.
"""

from __future__ import annotations

import dataclasses

HOP_LATENCY_S = 1e-6          # per ppermute hop (assumed)
COLLECTIVE_LATENCY_S = 5e-6   # per blocking collective dispatch (assumed)


def device_rates(device_kind: str | None = None):
    """(rates, link_bytes_per_s) from the device peak table: attention
    forward/backward matmul rates per kind, and one card's link rate in
    one direction. Raises KeyError for a device with no table row."""
    from quantizedattention_tpu.utils.profiling import device_peaks

    peaks = device_peaks(device_kind)
    bf16 = peaks["bf16_tflops"] * 1e12
    int8 = peaks["int8_tops"] * 1e12
    rates = {
        ("bf16", "fwd"): bf16,
        ("bf16", "bwd"): bf16,
        ("int8", "fwd"): int8,
        # the int8 backward runs three of its five products in int8
        ("int8", "bwd"): 1.0 / (0.6 / int8 + 0.4 / bf16),
    }
    return rates, peaks["nvlink_gbps_each_way"] * 1e9


@dataclasses.dataclass(frozen=True)
class SPWorkload:
    """One attention layer's sequence-parallel training step, per device."""

    b: int                 # global batch on this device's data slice
    h: int                 # q heads on this device's model slice
    h_kv: int              # kv heads (GQA: h_kv <= h rides the wire)
    t_local: int           # tokens per context shard
    d: int                 # head dim
    n: int                 # context shards
    causal: bool = True
    kind: str = "bf16"     # "bf16" | "int8" — wire format of the KV payload
    train: bool = True     # include the backward

    @property
    def kv_elt_bytes(self) -> float:
        # int8 payload + one f32 scale per 64-token quantization tile
        return 1.0 + 4.0 / (64 * self.d) if self.kind == "int8" else 2.0

    @property
    def t_global(self) -> int:
        return self.t_local * self.n


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-device cost of one step: FLOPs of the SLOWEST rank, exact link
    bytes sent per device, and the hop/collective count for latency."""

    flops_fwd: float
    flops_bwd: float
    link_fwd: float
    link_bwd: float
    hops_fwd: int
    hops_bwd: int
    overlapped: bool  # comm issued before compute it can hide behind


def _hop_flops(w: SPWorkload) -> float:
    """Matmul FLOPs of one full (non-causal) t_local x t_local attention
    hop: QK^T + PV, 2*2*b*h*t_local^2*d."""
    return 4.0 * w.b * w.h * w.t_local * w.t_local * w.d


def _live_hops(w: SPWorkload) -> float:
    """Causal: the slowest rank (idx n-1) runs n-1 full hops plus the
    half-masked diagonal hop; non-causal: n full hops."""
    return (w.n - 0.5) if w.causal else float(w.n)


_BWD_FLOPS_FACTOR = 2.5  # FA2 backward ~2.5x the forward matmul FLOPs


def ring_cost(w: SPWorkload) -> StepCost:
    """parallel/ring.py: fwd rotates (k, v) payload (n-1) times
    (_ring_bf16_fwd_impl:104-128 / int8 scales too, :232-259); bwd rotates
    (k, v) (n-1) times AND the f32 (dk, dv) accumulators n times
    (:153-189, :294-328). GQA rotates unrepeated h_kv heads."""
    shard = w.b * w.h_kv * w.t_local * w.d
    link_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    link_bwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes + w.n * 2 * shard * 4.0
    return StepCost(
        flops_fwd=_hop_flops(w) * _live_hops(w),
        flops_bwd=_BWD_FLOPS_FACTOR * _hop_flops(w) * _live_hops(w) if w.train else 0.0,
        link_fwd=link_fwd,
        link_bwd=link_bwd if w.train else 0.0,
        hops_fwd=w.n - 1,
        hops_bwd=2 * w.n - 1 if w.train else 0,
        overlapped=True,
    )


def allgather_cost(w: SPWorkload) -> StepCost:
    """parallel/collective.py allgather_kv_attention(_int8): fwd all-gathers
    the (n-1) remote K/V shards (:75-82 — int8 gathers quantized payload +
    scales, :154-157); bwd reduce-scatters f32 dK/dV home (:104-105,
    :181-182; a ring reduce moves ~(n-1) shard-sizes per device)."""
    shard = w.b * w.h_kv * w.t_local * w.d
    link_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    link_bwd = (w.n - 1) * 2 * shard * 4.0
    return StepCost(
        flops_fwd=_hop_flops(w) * _live_hops(w),
        flops_bwd=_BWD_FLOPS_FACTOR * _hop_flops(w) * _live_hops(w) if w.train else 0.0,
        link_fwd=link_fwd,
        link_bwd=link_bwd if w.train else 0.0,
        hops_fwd=2,       # two all-gathers
        hops_bwd=2 if w.train else 0,  # two reduce-scatters
        overlapped=False,
    )


def ulysses_cost(w: SPWorkload) -> StepCost:
    """parallel/ulysses.py: three input all_to_alls (q, k, v re-shard
    seq->head) + one output all_to_all (o, f32) forward (:44-52); the
    transpose repeats them backward. Each all_to_all moves (n-1)/n of the
    local tensor. Requires n <= h_kv; causal work is BALANCED (every rank
    holds the full sequence for its heads)."""
    frac = (w.n - 1) / w.n
    qkv_bytes = (w.b * w.h * w.t_local * w.d          # q at input dtype (2B)
                 + 2 * w.b * w.h_kv * w.t_local * w.d) * 2.0
    o_bytes = w.b * w.h * w.t_local * w.d * 4.0       # o / do are f32
    link_fwd = frac * (qkv_bytes + o_bytes)
    link_bwd = frac * (qkv_bytes + o_bytes)            # transposed a2a set
    causal_factor = 0.5 if w.causal else 1.0
    flops_fwd = _hop_flops(w) * w.n * causal_factor   # balanced: true halving
    return StepCost(
        flops_fwd=flops_fwd,
        flops_bwd=_BWD_FLOPS_FACTOR * flops_fwd if w.train else 0.0,
        link_fwd=link_fwd,
        link_bwd=link_bwd if w.train else 0.0,
        hops_fwd=4,
        hops_bwd=4 if w.train else 0,
        overlapped=False,
    )


def zigzag_cost(w: SPWorkload) -> StepCost:
    """parallel/zigzag.py: the striped causal ring. Same wire traffic as the
    contiguous ring (the two-chunk kv pair totals t_local tokens per hop;
    bwd adds the f32 dk/dv pair rotations), but causal work is BALANCED:
    every rank computes exactly 2n+1 half-hop [c x c] pieces, i.e.
    (2n+1)/(2n) of the ideal balanced causal FLOPs. Non-causal degenerates
    to the plain ring."""
    if not w.causal:
        return ring_cost(w)
    shard = w.b * w.h_kv * w.t_local * w.d
    link_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    link_bwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes + w.n * 2 * shard * 4.0
    # exactly the ideal balanced causal work (2 diagonal halves + 2n-1 full
    # [c x c] pieces = 2n*c^2 pair units) — expressed with the same
    # (1 + 1/n) diagonal convention predict_step's ideal uses, so the
    # efficiency reflects only communication exposure
    flops_fwd = _hop_flops(w) * w.n * 0.5 * (1.0 + 1.0 / w.n)
    return StepCost(
        flops_fwd=flops_fwd,
        flops_bwd=_BWD_FLOPS_FACTOR * flops_fwd if w.train else 0.0,
        link_fwd=link_fwd,
        link_bwd=link_bwd if w.train else 0.0,
        hops_fwd=w.n - 1,
        hops_bwd=2 * w.n - 1 if w.train else 0,
        overlapped=True,
    )


COSTS = {"ring": ring_cost, "allgather": allgather_cost, "ulysses": ulysses_cost,
         "zigzag": zigzag_cost}


@dataclasses.dataclass(frozen=True)
class Prediction:
    t_comp_s: float
    t_comm_s: float
    t_step_s: float
    efficiency: float   # ideal balanced compute time / predicted step time


def predict_step(
    w: SPWorkload,
    variant: str,
    rates: dict,
    link_bytes_per_s: float,
    hop_latency_s: float = HOP_LATENCY_S,
    collective_latency_s: float = COLLECTIVE_LATENCY_S,
) -> Prediction:
    """Predicted per-step wall time and weak-scaling efficiency at the given
    rates ({(kind, "fwd"|"bwd"): FLOP/s}, see device_rates).

    efficiency = T_ideal / T_pred, where T_ideal is the perfectly balanced
    causal compute time (total FLOPs / n / rate) — so both exposed
    communication AND causal load imbalance count against the strategy.
    """
    cost = COSTS[variant](w)
    r_fwd = rates[(w.kind, "fwd")]
    r_bwd = rates[(w.kind, "bwd")]
    t_comp = cost.flops_fwd / r_fwd + (cost.flops_bwd / r_bwd if w.train else 0.0)
    t_comm = (cost.link_fwd + cost.link_bwd) / link_bytes_per_s
    latency = (cost.hops_fwd + cost.hops_bwd) * (
        hop_latency_s if cost.overlapped else collective_latency_s
    )
    if cost.overlapped:
        t_step = max(t_comp, t_comm) + latency
    else:
        t_step = t_comp + t_comm + latency
    # ideal: causal work perfectly balanced over ranks
    causal_factor = 0.5 * (1.0 + 1.0 / w.n) if w.causal else 1.0
    ideal_fwd = _hop_flops(w) * w.n * causal_factor / r_fwd
    ideal = ideal_fwd * (1.0 + (_BWD_FLOPS_FACTOR * r_fwd / r_bwd if w.train else 0.0))
    return Prediction(
        t_comp_s=t_comp,
        t_comm_s=t_comm,
        t_step_s=t_step,
        efficiency=min(1.0, ideal / t_step),
    )


def predict_all(w: SPWorkload, rates: dict, link_bytes_per_s: float) -> dict:
    out = {}
    for variant in COSTS:
        if variant == "ulysses" and w.n > w.h_kv:
            continue  # head-divisibility constraint
        out[variant] = predict_step(w, variant, rates, link_bytes_per_s)
    return out


def best_sp_variant(
    h: int,
    h_kv: int,
    t_local: int,
    d: int,
    n: int,
    kind: str = "bf16",
    causal: bool = True,
    allow_ulysses: bool = True,
    allow_zigzag: bool = True,
    rates: dict | None = None,
    link_bytes_per_s: float | None = None,
) -> str:
    """Predicted-best TRAIN-STEP strategy among those the train step can use
    ("ring" | "allgather" | "ulysses" | "zigzag" — models/sharded_train.py's
    attention_sp knob; zigzag is considered only when `allow_zigzag` and the
    workload is causal, since the striped layout exists to balance causal
    work). Batch cancels (comm and comp both scale linearly), so it is not
    needed.

    rates/link_bytes_per_s default to this device's row of the peak table
    (device_rates); a device with no row raises.

    The model's shape: ULYSSES dominates causal training whenever its
    head-divisibility constraint allows (causal work is balanced across
    ranks — the ring and all-gather are bound by the last rank's ~n-1/2
    live hops); among ring vs all-gather, the ring wins once per-hop
    compute exceeds per-hop comm (long t_local, big d), the all-gather when
    dependent hop latencies and the ring's extra f32 dk/dv rotations
    dominate short shards.
    """
    if rates is None or link_bytes_per_s is None:
        dev_rates, dev_link = device_rates()
        rates = dev_rates if rates is None else rates
        link_bytes_per_s = dev_link if link_bytes_per_s is None else link_bytes_per_s
    w = SPWorkload(b=1, h=h, h_kv=h_kv, t_local=t_local, d=d, n=n,
                   causal=causal, kind=kind)
    cands = ["ring", "allgather"]
    if allow_ulysses and n <= h_kv and h % n == 0 and h_kv % n == 0:
        cands.append("ulysses")
    if allow_zigzag and causal:
        cands.append("zigzag")
    preds = {v: predict_step(w, v, rates, link_bytes_per_s) for v in cands}
    return min(preds, key=lambda v: preds[v].t_step_s)
