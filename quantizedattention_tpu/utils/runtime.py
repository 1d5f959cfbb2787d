"""Small runtime helpers shared across kernels, scripts and tests."""

from __future__ import annotations

import os

import jax

# The checkout's root: one level above the package directory.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_COMPILE_CACHE = os.path.join(REPO_ROOT, ".jax_cache")


def use_interpret_mode() -> bool:
    """True when Pallas kernels should run in the interpreter.

    Only the CPU backend interprets (the test suite and the multi-device
    dry runs). On a GPU every kernel compiles through its named route; any
    other backend has no route here and raises, so a kernel can never fall
    back to the interpreter on an accelerator unnoticed.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no kernel route for backend {backend!r} (cpu or gpu only)")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for a script; returns the
    directory in use.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here. Otherwise the cache lives at a fixed directory inside the
    checkout (`.jax_cache`, gitignored): the path is part of the cache key,
    so it must not move between runs. The library never calls this on
    import; scripts (bench, chip smoke, examples) do.
    """
    env = os.environ.get(_CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()
