"""Multi-host glue: process init + a hybrid mesh over hosts.

The kernels and collectives in this package are mesh-agnostic; what a
multi-host run additionally needs is (a) per-process runtime initialization
and (b) a mesh whose axes keep the bandwidth-hungry collectives (head-TP
psum, ring ppermute) among the cards of one host, joined by NVLink, while
only the data-parallel gradient psum crosses the network between hosts —
the layout `make_pod_mesh` builds:

    data axis    = (host replicas) x (in-host data groups) — hosts outermost
    model axis   = within one host (head-TP psum per layer)
    context axis = within one host (ring ppermute per kv hop)

Devices are grouped into hosts by `process_index` (one process per host).
In a single process (emulated devices) the host grouping degenerates to
contiguous device blocks, so the same launch script runs everywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the JAX distributed runtime for a multi-host run.

    Pass coordinator_address ("host:port"), num_processes and process_id;
    with no arguments it relies on a cluster launcher's environment (the
    standard `jax.distributed.initialize()` auto-detection). No-op if
    the runtime is already initialized. Must run before any JAX computation
    touches a backend — probing jax.devices()/process_count() here would
    lock in a local-only runtime, so the check uses
    jax.distributed.is_initialized() only.
    """
    if jax.distributed.is_initialized():
        return  # already initialized (by the launcher or a prior call)
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except (ValueError, RuntimeError):
        if explicit:
            # a typo'd coordinator or late call must not silently degrade
            # into N independent single-host runs
            raise
        # auto-detection found no cluster: single-process run


def make_pod_mesh(
    data_dcn: int = 1,
    data: int = 1,
    model: int = 1,
    context: int = 1,
) -> Mesh:
    """Mesh('data', 'model', 'context') with host replicas outermost on data.

    data_dcn: hosts combined over the network — pure data parallelism
    across them (the gradient psum is the only traffic between hosts).
    data/model/context: the within-host factorization, same semantics as
    make_attention_mesh. Requires data_dcn * data * model * context ==
    len(jax.devices()).
    """
    n = data_dcn * data * model * context
    devices = jax.devices()
    if n != len(devices):
        raise ValueError(f"mesh {data_dcn}x{data}x{model}x{context}={n} != {len(devices)} devices")
    if data_dcn > 1 and jax.process_count() == data_dcn:
        # one process per host: each host's cards form one replica group
        by_host = sorted(devices, key=lambda d: (d.process_index, d.id))
        dev_array = np.asarray(by_host).reshape(data_dcn, data, model, context)
    elif data_dcn > 1:
        # single process (emulated devices): contiguous device blocks stand
        # in for hosts so the same script stays runnable in CI
        dev_array = np.asarray(devices).reshape(data_dcn, data, model, context)
    else:
        dev_array = np.asarray(devices).reshape(data, model, context)
    return Mesh(dev_array.reshape(data_dcn * data, model, context),
                ("data", "model", "context"))
