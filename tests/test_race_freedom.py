"""Race-freedom and decomposition-invariance of the Pallas kernels.

SURVEY.md §2.3 Q2: the reference's backward accumulates dq through a
global-memory read-modify-write that races across k-tile programs. These kernels are
designed so every output element is owned by exactly one program; this file
operationalizes that claim:

  * determinism — repeated runs are bit-identical (a racing accumulation
    would produce run-to-run wobble);
  * decomposition invariance — changing the grid decomposition (block
    sizes) only reorders f32 reductions; results stay within a few ulps,
    nowhere near the magnitude a lost-update race would produce.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
from quantizedattention_tpu.tune.config import BlockConfig
from tests.conftest import make_qkv


def test_fwd_deterministic_across_runs(rng):
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=384)
    a, _ = flash_attention_fwd(q, k, v, causal=True)
    b, _ = flash_attention_fwd(q, k, v, causal=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bwd_deterministic_across_runs(rng):
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=384)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    g1 = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)
    g2 = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bq,bkv", [(32, 32), (32, 128), (128, 32)])
def test_bwd_decomposition_invariance(rng, bq, bkv):
    """dK/dV accumulate across q-tiles and dQ across kv-tiles in each
    program's registers: re-tiling must only reorder f32 adds (ulp-scale
    drift), never lose an update."""
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=384)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ref_cfg = BlockConfig(block_q_bwd=64, block_kv_bwd=64)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=True, config=ref_cfg, fast=True)
    cfg = BlockConfig(block_q_bwd=bq, block_kv_bwd=bkv)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, config=cfg, fast=True)
    for nm, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float(jnp.max(jnp.abs(a - b)))
        assert err < 1e-4, f"{nm}: {err} (lost-update races are O(1))"


def test_int8_fwd_decomposition_invariance(rng):
    """int8 path: quantization granularity IS part of the numerical
    contract — K/V scales are per kv tile and P is quantized per row of
    each kv tile (sp = exp2(rowmax − m)/127), so re-tiling legitimately
    shifts results by up to ~1/127 of the output scale. The decomposition
    check therefore bounds the difference by the int8 rounding envelope (a
    lost-update race would be O(1)), and determinism (below) is exact."""
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    a, _, _ = int8_attention_fwd(q, k, v, causal=True,
                                 config=BlockConfig(block_q=128, block_kv=128))
    b, _, _ = int8_attention_fwd(q, k, v, causal=True,
                                 config=BlockConfig(block_q=128, block_kv=64))
    assert float(jnp.max(jnp.abs(a - b))) < 5e-2  # int8 envelope, not ulps
    a2, _, _ = int8_attention_fwd(q, k, v, causal=True,
                                  config=BlockConfig(block_q=128, block_kv=128))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
