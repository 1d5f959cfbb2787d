"""The bf16 tied-max amplification rule from arXiv:2510.04212.

Why: in bf16 flash attention, the un-normalized probability of the row-max
logit is exp2(m - m) = 1.0 exactly. When *several* logits tie for the max,
each of them rounds to 1.0 in bf16 (7 mantissa bits), the per-row sum `l`
under-resolves their differences, and training diverges (the failure mode
analyzed in arXiv:2510.04212 and github.com/ucker/why-low-precision-training-
fails). The fix: when more than one logit in a row is within `tol` of the
running max, amplify the max so every exp2(S - m) lands strictly below 1,
where bf16 has full relative resolution:

    m <- BETA * m   if m > 0        (pushes exp2(S - m) <= exp2(-(BETA-1) m) < 1)
    m <- 0          if m < 0        (pushes exp2(S - m) <= exp2(S) < 1)

with BETA = 2.0 (the reference notes BETA = 8.0 overflows to NaN,
attention_bf16.py:146-147).

Reference behavior: attention_bf16.py:241-264. One intentional divergence
(SURVEY.md §2.3): the reference compares the *unscaled* logits S against the
*scaled* running max (attention_bf16.py:248); we compare scaled-to-scaled,
which is the intended "tied max" detection.
"""

from __future__ import annotations

import jax.numpy as jnp

BETA = 2.0
APPROX_MAX_TOL = 1e-3

# The zero-cost variant ("eps" rule): in exact arithmetic any
# per-row bias of the running max cancels in the softmax normalization
# (O = PV / sum(P) is invariant to m), so biasing next_m by one bf16 ulp
# pushes EVERY un-normalized P entry to exp2(-EPS_BIAS) = 0.9973, which
# rounds to bf16 0.99609 — strictly below 1.0, the same guarantee the BETA
# rule buys for tied rows, at [bq,1] cost instead of two full-tile VPU
# passes (detection compare + count reduce). Both rules are exposed; "beta"
# is the reference-parity behavior, "eps" the default.
EPS_BIAS = 2.0 ** -8


def amplify_tied_max(
    s_scaled: jnp.ndarray,
    next_m: jnp.ndarray,
    beta: float = BETA,
    tol: float = APPROX_MAX_TOL,
) -> jnp.ndarray:
    """Amplify the running max where a row has >1 near-max logit.

    Args:
      s_scaled: scaled logits for the current tile, [..., q, k] (any float dtype).
      next_m: candidate running max, [..., q, 1], same dtype family.

    Returns the corrected running max with the same shape/dtype as `next_m`.
    """
    approx_max = s_scaled >= (next_m - tol)
    num_approx = jnp.sum(approx_max.astype(jnp.int32), axis=-1, keepdims=True)
    tied = num_approx > 1
    amplified = jnp.where(next_m > 0, beta * next_m, jnp.zeros_like(next_m))
    return jnp.where(tied, amplified, next_m)
