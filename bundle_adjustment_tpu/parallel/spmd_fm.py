"""SPMD LM step on the feature-major engine: point-axis sharding.

parallel/spmd.py shards the observation axis of the legacy block layout
(scatter segment-sums — the formulation rcs.py documents as the hot-loop
bottleneck).  This module shards the **uniform point-major axis** of the
feature-major engine instead (survey section 2.J's SP analogue / point-axis
scaling):

* every device owns a contiguous block of P/D points and all V views of
  each (point reductions stay shard-local reshapes — zero communication);
* per-image reductions run the scatter-free blocked layout per shard with
  a *per-shard* static permutation, then one psum combines the [M, F]
  partials;
* the reduced system (cameras + globals) is replicated; the PCG loop runs
  redundantly with a single psum pair per matvec.

This is the multi-chip path of the flagship engine: the same
linearise/prepare/matvec code runs with `axis=` set, so single-chip and
SPMD numerics differ only by summation order.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.problem import ParamState
from . import engine, rcs

AXIS = "pts"


def pad_for_mesh(problem: rcs.RCSProblem, state: ParamState, mesh: Mesh,
                 axis: str = AXIS, multiple: int = 1,
                 images: bool = False):
    """Pad the point count so every shard holds the same number of whole
    points (and optionally a multiple of ``multiple``).  With
    ``images`` also pad the image count to the mesh size (fully-fixed
    dummy images) as the camera-sharded TP step requires."""
    D = mesh.shape[axis]
    m = D * multiple // math.gcd(D, multiple) if multiple > 1 else D
    problem, state, Pn = engine.pad_problem(problem, state, multiple=m)
    if images:
        problem, state, _ = engine.pad_images(problem, state, D)
    return problem, state, Pn


def shard_arrays(problem: rcs.RCSProblem, state: ParamState, mesh: Mesh,
                 axis: str = AXIS):
    """Host-side preparation: per-shard image-reduction layouts and sharded
    device arrays.  Returns (args tuple for the mapped step, in_specs)."""
    D = mesh.shape[axis]
    Pn = problem.num_points
    V = problem.point_uniform
    if Pn % D != 0:
        raise ValueError("pad the problem first (pad_for_mesh)")
    P_loc = Pn // D
    N_loc = P_loc * V
    M = problem.num_images

    obs_image_np = np.asarray(problem.obs_image).reshape(D, N_loc)
    perms, starts = [], []
    for d in range(D):
        pm, st = rcs.build_image_block_layout(obs_image_np[d], M)
        perms.append(pm)
        starts.append(st)
    nip = max(pm.shape[0] for pm in perms)
    nip = -(-nip // rcs.IMG_BLOCK) * rcs.IMG_BLOCK
    perm_arr = np.full((D, nip), N_loc, np.int32)
    starts_arr = np.zeros((D, M + 1), np.int32)
    for d in range(D):
        perm_arr[d, :perms[d].shape[0]] = perms[d]
        starts_arr[d] = starts[d]

    def put(a, *spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))

    w = problem.obs_weight
    args = dict(
        obs_image=put(problem.obs_image, axis),
        obs_x=put(problem.obs_xy[:, 0], axis),
        obs_y=put(problem.obs_xy[:, 1], axis),
        wxx=put(w[:, 0, 0], axis),
        wxy=put(w[:, 0, 1], axis),
        wyy=put(w[:, 1, 1], axis),
        free_point=put(problem.free_point, axis, None),
        points=put(state.points, axis, None),
        img_perm=put(perm_arr, axis, None),
        img_block_starts=put(starts_arr, axis, None),
        io=put(state.io), dist=put(state.dist), eo=put(state.eo),
    )
    specs = dict(
        obs_image=P(axis), obs_x=P(axis), obs_y=P(axis),
        wxx=P(axis), wxy=P(axis), wyy=P(axis),
        free_point=P(axis, None), points=P(axis, None),
        img_perm=P(axis, None), img_block_starts=P(axis, None),
        io=P(), dist=P(), eo=P(),
    )
    return args, specs, P_loc


def make_spmd_fm_lm_step(problem: rcs.RCSProblem, state: ParamState,
                         spec, mesh: Mesh, damping=1e-4,
                         cg_tol=1e-6, cg_maxiter=200,
                         couple_global: bool = True, axis: str = AXIS,
                         cam_shard: bool = False, stall_limit=None):
    """Build the jitted point-sharded FM LM step.

    Returns (step, args0) where ``step(points, io, dist, eo) ->
    (new (points, io, dist, eo), max_dx, omega0, cg_it)`` — the parameter
    blocks travel through so the returned function can be iterated; points
    stay sharded over the mesh, the rest replicated.

    ``cam_shard``: tensor-parallel mode (survey section 2.J TP row) — the
    reduced camera system is additionally *sharded by image rows* over the
    same mesh axis: the fused [M, F] image reduction lands via one
    reduce_scatter (each device owns M/D images' reduced rows and their
    6x6 preconditioner factorization panels), the PCG state is camera-
    sharded with psum-ed dots, and the matvec re-forms the tiny full [M, 6]
    vector with one tiled all_gather.  Requires M %% mesh size == 0.
    Numerics are identical to the replicated path up to summation order.
    """
    args, specs, P_loc = shard_arrays(problem, state, mesh, axis)
    if cam_shard and problem.num_images % mesh.shape[axis] != 0:
        raise ValueError(
            f"cam_shard requires the image count ({problem.num_images}) to "
            f"be a multiple of the mesh size ({mesh.shape[axis]})")
    M = problem.num_images
    V = problem.point_uniform
    dt = problem.obs_xy.dtype

    def local_step(obs_image, obs_x, obs_y, wxx, wxy, wyy, free_point,
                   points, img_perm, img_block_starts, io, dist, eo):
        p_loc = engine.FMProblem(
            obs_point=None, obs_image=obs_image,
            cam_of_image=jnp.asarray(problem.cam_of_image),
            obs_x=obs_x, obs_y=obs_y, wxx=wxx, wxy=wxy, wyy=wyy,
            r0=jnp.asarray(problem.r0), num_points=P_loc, num_images=M,
            views=V,
            free_point=free_point.T, free_eo=jnp.asarray(problem.free_eo),
            free_global=jnp.asarray(problem.free_global),
            img_perm=img_perm[0], img_block_starts=img_block_starts[0],
        )
        st = ParamState(points=points, io=io, dist=dist, eo=eo)
        b, rc, rg, Minv = engine.prepare(
            p_loc, st, spec, jnp.asarray(damping, dt),
            couple_global=couple_global, axis=axis, cam_scatter=cam_shard)
        b, rc, rg, Minv = jax.lax.optimization_barrier((b, rc, rg, Minv))

        def matvec(c, g):
            return engine.schur_matvec(p_loc, b, c, g, axis=axis,
                                       cam_scatter=cam_shard)

        xc, xg, it = rcs.pcg(None, None, rc, rg, Minv, tol=cg_tol,
                             maxiter=cg_maxiter, matvec=matvec,
                             stall_limit=stall_limit,
                             axis_cam=axis if cam_shard else None)
        if cam_shard:
            xc = jax.lax.all_gather(xc, axis, axis=0, tiled=True)
        dxp = engine.back_substitute_points(p_loc, b, xc, xg)

        C = io.shape[0]
        K = dist.shape[1]
        g = xg.reshape(C, 3 + K)
        new = (points + dxp, io + g[:, :3], dist + g[:, 3:], eo + xc)
        max_dx = jnp.maximum(
            jax.lax.pmax(jnp.max(jnp.abs(dxp)), axis),
            jnp.maximum(jnp.max(jnp.abs(xc)), jnp.max(jnp.abs(xg))))
        return new, max_dx, b.omega0, it

    names = ["obs_image", "obs_x", "obs_y", "wxx", "wxy", "wyy",
             "free_point", "points", "img_perm", "img_block_starts",
             "io", "dist", "eo"]
    in_specs = tuple(specs[n] for n in names)
    out_specs = ((P(axis, None), P(), P(), P()), P(), P(), P())
    mapped = jax.shard_map(local_step, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)

    @jax.jit
    def _step(*a):
        return mapped(*a)

    static = tuple(args[n] for n in names[:7]) + ()
    perm_args = (args["img_perm"], args["img_block_starts"])

    def step(points, io, dist, eo):
        a = (args["obs_image"], args["obs_x"], args["obs_y"], args["wxx"],
             args["wxy"], args["wyy"], args["free_point"], points,
             perm_args[0], perm_args[1], io, dist, eo)
        return _step(*a)

    args0 = (args["points"], args["io"], args["dist"], args["eo"])
    return step, args0
