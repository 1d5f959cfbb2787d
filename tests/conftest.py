"""Test environment: CPU backend with 8 emulated devices.

Kernels run in Pallas interpret mode (use_interpret_mode is true on the CPU
only), so the whole suite runs without a card; the distributed tests use the
8 emulated host devices as a mesh stand-in. The platform is forced through
jax.config before any backend initializes.

Tests that need the card carry the `gpu` marker (registered in
pyproject.toml). Whether a card is present is decided inside the
`_gpu_marker` fixture, never at import or collection time, so every xdist
worker collects the same tests; here they skip with a reason, and
chip_smoke.py runs the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return jax.random.key(42)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled kernels); chip_smoke.py runs "
                    "this check on the card")


@pytest.fixture
def h100_rates(monkeypatch):
    """attention_sp="auto" ranks strategies at the running device's row of
    the peak table; the CPU has none, so these tests rank at the H100's."""
    from quantizedattention_tpu.parallel import scaling_model

    row = scaling_model.device_rates("NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(scaling_model, "device_rates", lambda device_kind=None: row)


def make_qkv(rng, batch=1, head=2, q_tokens=256, kv_tokens=None, head_dim=64, dtype=jnp.float32):
    kv_tokens = q_tokens if kv_tokens is None else kv_tokens
    kq, kk, kv, kd = jax.random.split(rng, 4)
    q = jax.random.normal(kq, (batch, head, q_tokens, head_dim), dtype)
    k = jax.random.normal(kk, (batch, head, kv_tokens, head_dim), dtype)
    v = jax.random.normal(kv, (batch, head, kv_tokens, head_dim), dtype)
    do = jax.random.normal(kd, (batch, head, q_tokens, head_dim), dtype)
    return q, k, v, do
