"""Failure detection for long-running training/serving jobs.

The reference has nothing here (SURVEY.md §5 — judged the thinnest row in
round 1). Under XLA's SPMD model a sick card or a dead host usually
presents as a COLLECTIVE THAT NEVER COMPLETES (the psum/ppermute blocks
forever inside XLA, NCCL waiting on a peer) or as a device call that stops
returning — not as an error code. So detection is deadline-based:

  * `Watchdog` — generic deadline monitor: runs `probe()` on a worker
    thread every `interval_s`; if a probe exceeds `timeout_s` the failure
    callback fires (once) with a diagnostic. Used for device heartbeats.
  * `device_heartbeat` — a tiny device round-trip returning latency; the
    canonical probe (catches a wedged runtime or a hung device).
  * `hosts_alive` — a psum of ones over all processes under a deadline:
    every live host contributes 1, so a missing/dead host makes the
    collective hang and the deadline converts that hang into a detection.
  * `StepGuard` — training-loop integration: wraps a step callable,
    records durations, flags a STALL when a step exceeds
    `stall_factor x median` (wedged collective / straggler host), and
    invokes an optional `on_stall` (e.g. trigger a checkpoint + abort so
    the launcher can restart from utils/checkpoint).

Recovery is restart-based (there is no per-chip eviction under
XLA's SPMD model): detect fast, checkpoint often (utils/checkpoint has the
sharded Orbax path), and let the launcher respawn — these utilities cover
the detect-fast leg and the decide-to-restart signal.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp


class _ProbeTimeout(Exception):
    pass


def _run_with_deadline(fn, timeout_s: float):
    """Run fn() on a DAEMON thread; raise _ProbeTimeout after timeout_s.

    Deliberately not a ThreadPoolExecutor: its workers are non-daemon and
    joined at interpreter exit (and at `with` exit), so a probe wedged in a
    hung collective would (a) block the timeout from propagating out of the
    `with` block and (b) prevent the process from ever exiting — exactly
    wrong for a failure detector whose reaction is checkpoint-then-restart.
    A daemon thread is abandoned: the worker leaks until process exit, which
    is the accepted cost of detecting an unrecoverable hang.
    """
    q: queue.Queue = queue.Queue(maxsize=1)

    def _runner():
        try:
            q.put(("ok", fn()))
        except Exception as e:  # noqa: BLE001 — passed on to the caller
            q.put(("err", e))

    t = threading.Thread(target=_runner, daemon=True)
    t.start()
    try:
        status, payload = q.get(timeout=timeout_s)
    except queue.Empty:
        raise _ProbeTimeout(f"probe exceeded {timeout_s}s deadline") from None
    if status == "err":
        raise payload
    return payload


def device_heartbeat(device=None) -> float:
    """Seconds for one tiny device round-trip (compile cached after first).

    A healthy card answers in milliseconds; a wedged
    runtime never returns — pair with `Watchdog` for the deadline.
    """
    t0 = time.perf_counter()
    x = jnp.ones((8, 8))
    if device is not None:
        x = jax.device_put(x, device)
    float(jnp.sum(x * 2.0))
    return time.perf_counter() - t0


def hosts_alive(timeout_s: float = 60.0) -> int:
    """Count of live processes via a deadline-guarded psum of ones.

    Returns jax.process_count() when every host participates. If any host
    is dead the collective cannot complete; the deadline raises
    TimeoutError instead of hanging the job forever.
    """
    n_proc = jax.process_count()
    if n_proc == 1:
        device_heartbeat()  # still verify the local device answers
        return 1

    def _probe():
        from jax.sharding import NamedSharding, PartitionSpec as P

        # the array must be GLOBALLY SHARDED over the multi-process mesh so
        # the sum lowers to a cross-host all-reduce — a host-local replicated
        # array would reduce locally and never block on a dead host
        mesh = jax.make_mesh((jax.device_count(),), ("d",))
        ones = jax.device_put(
            jnp.ones((jax.device_count(),)), NamedSharding(mesh, P("d"))
        )
        total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(ones)
        return int(total)

    try:
        devices_seen = _run_with_deadline(_probe, timeout_s)
    except _ProbeTimeout as e:
        # the probe thread is wedged in the hung collective; it is a daemon
        # thread, so raising here neither joins it nor blocks process exit
        raise TimeoutError(
            f"hosts_alive: collective did not complete within {timeout_s}s "
            f"— at least one of {n_proc} hosts is unreachable"
        ) from e
    return n_proc if devices_seen == jax.device_count() else devices_seen


@dataclass
class FailureEvent:
    kind: str          # "probe_timeout" | "probe_error" | "stall"
    detail: str
    elapsed_s: float
    at: float = field(default_factory=time.time)


class Watchdog:
    """Deadline monitor: `probe()` every `interval_s`; `on_failure(event)`
    fires (once) if a probe exceeds `timeout_s` or raises."""

    def __init__(self, probe=device_heartbeat, interval_s: float = 30.0,
                 timeout_s: float = 120.0, on_failure=None):
        self._probe = probe
        self._interval = interval_s
        self._timeout = timeout_s
        self._on_failure = on_failure
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.failures: list[FailureEvent] = []
        self.probes_ok = 0
        self.last_latency_s: float | None = None

    def _fail(self, event: FailureEvent):
        self.failures.append(event)
        if self._on_failure is not None:
            self._on_failure(event)

    def _loop(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                out = _run_with_deadline(self._probe, self._timeout)
                self.last_latency_s = out if isinstance(out, float) else (
                    time.perf_counter() - t0)
                self.probes_ok += 1
            except _ProbeTimeout:
                self._fail(FailureEvent(
                    "probe_timeout",
                    f"probe exceeded {self._timeout}s deadline",
                    time.perf_counter() - t0,
                ))
                return  # a hung probe thread cannot be reclaimed; stop
            except Exception as e:  # noqa: BLE001 — surface any probe error
                self._fail(FailureEvent(
                    "probe_error", f"{type(e).__name__}: {e}",
                    time.perf_counter() - t0,
                ))
                return
            self._stop.wait(self._interval)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._timeout + 1.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class StepGuard:
    """Wraps a training step: duration stats + stall detection.

    A step slower than `stall_factor` x the running median (after
    `warmup_steps`) flags a stall — the signature of a wedged collective or
    a straggler host — and calls `on_stall(event)` (checkpoint + abort is
    the intended reaction; utils/checkpoint restores on restart).
    """

    def __init__(self, step_fn, stall_factor: float = 10.0,
                 warmup_steps: int = 3, on_stall=None):
        self._fn = step_fn
        self._factor = stall_factor
        self._warmup = warmup_steps
        self._on_stall = on_stall
        self.durations: list[float] = []
        self.stalls: list[FailureEvent] = []

    def _median(self) -> float:
        ds = sorted(self.durations)
        return ds[len(ds) // 2]

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        # JAX returns before the device finishes: wait for every output so
        # the duration covers the step's execution, not its dispatch
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        if len(self.durations) >= self._warmup and dt > self._factor * self._median():
            ev = FailureEvent(
                "stall", f"step took {dt:.3f}s vs median {self._median():.3f}s", dt
            )
            self.stalls.append(ev)
            if self._on_stall is not None:
                self._on_stall(ev)
        self.durations.append(dt)
        return out
