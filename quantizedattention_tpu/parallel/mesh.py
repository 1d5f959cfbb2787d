"""Mesh construction helpers.

Axis convention (jax-ml.github.io/scaling-book recipe: pick a mesh, annotate
shardings, let XLA insert collectives):

  data     — batch (DP); no communication inside attention
  model    — heads (TP); communication-free inside attention, psum later at
             the output projection
  context  — sequence (SP/CP); ring attention rotates KV over this axis

The cards of one host are joined all to all, so the axis order follows the
algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_attention_mesh(
    data: int = 1,
    model: int = 1,
    context: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, model, context) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    want = data * model * context
    if want > len(devices):
        raise ValueError(f"mesh needs {want} devices, have {len(devices)}")
    import numpy as np

    arr = np.asarray(devices[:want]).reshape(data, model, context)
    return Mesh(arr, axis_names=("data", "model", "context"))
