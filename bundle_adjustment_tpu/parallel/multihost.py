"""Multi-host orchestration helpers.

Multi-host runs (BASELINE config 5: 5k images / 1M points over N >= 2
hosts) use standard JAX multi-controller SPMD: every host runs the same
program, `jax.distributed.initialize` wires the controllers together and
the global mesh spans all devices; the shard_map LM step (parallel/spmd.py)
then runs unchanged — psum collectives run over the links within a host
(NVLink between the GPUs of one machine) and the network between hosts.

The reference has no distributed mode (survey section 2.J) — this subsystem
is new capability.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Wire up the multi-controller runtime.  Where a cluster manager
    provides the topology all arguments are auto-detected; pass them
    explicitly elsewhere (e.g. COORDINATOR=host0:1234 for CPU
    multi-process tests)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "obs"):
    """1-D mesh over every device of every host (observation data
    parallel)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def scenario_mesh(scenario_axis: str = "scenario", obs_axis: str = "obs",
                  scenarios_per_host: int = 1):
    """2-D mesh for scenario-batched fleets: the scenario axis spans hosts
    (no cross-scenario communication -> friendly to the slower network
    between hosts), the observation axis spans the devices within a host
    (psum over the links between them)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    n = devs.size
    s = min(scenarios_per_host * max(1, jax.process_count()), n)
    while n % s != 0:
        s -= 1
    return Mesh(devs.reshape(s, n // s), (scenario_axis, obs_axis))


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
