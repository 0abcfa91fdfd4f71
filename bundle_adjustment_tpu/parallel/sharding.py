"""Multi-device sharding of the bundle-adjustment compute path.

The reference is single-threaded (survey section 2.J); this module is the
array-native scaling design: observations are sharded across a device mesh,
each device accumulates partial J^T W J / J^T W w contributions for the
*reduced* camera system, and `psum` over the mesh combines them — the
collectives run over the device interconnect.  Point blocks (Hpp, 3x3 per
point) are data-parallel over the observation shards as well because
segment-sums commute with psum.

Layout:
    mesh axis "obs"  — observation batches (data parallelism)
The small reduced camera system (6M + IO + dist) is replicated; at 5k images
it is ~30k x 30k and would instead be sharded over a second axis (see
parallel/rcs.py for the large-scale solver).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "obs") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_observations(problem, mesh: Mesh, axis: str = "obs"):
    """Pads the observation index arrays to a multiple of the mesh size and
    returns (padded arrays dict, valid mask) with shardings applied.

    Padding rows point at index 0 with zero weight — they contribute exactly
    nothing to any reduction.
    """
    n_dev = mesh.shape[axis]
    N = problem.num_image_obs
    Np = pad_to_multiple(max(N, 1), n_dev)

    def pad(a, fill=0):
        a = np.asarray(a)
        out = np.full((Np,) + a.shape[1:], fill, a.dtype)
        out[:N] = a
        return out

    sharding = NamedSharding(mesh, P(axis, *([None] * 0)))

    arrays = {
        "obs_point": pad(problem.obs_point),
        "obs_image": pad(problem.obs_image),
        "obs_xy": pad(problem.obs_xy),
        "obs_var": pad(problem.obs_var, fill=1.0),
        "obs_rho": pad(problem.obs_rho),
        "valid": np.arange(Np) < N,
    }
    out = {}
    for k, v in arrays.items():
        spec = P(axis) if v.ndim == 1 else P(axis, *([None] * (v.ndim - 1)))
        out[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
    return out
