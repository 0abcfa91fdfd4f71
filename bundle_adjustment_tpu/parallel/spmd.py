"""Explicit SPMD LM step: shard_map over the observation axis.

The jit-autosharding path (__graft_entry__.dryrun_multichip) lets XLA place
collectives; this module is the explicit formulation for pod-scale control:
each device holds a contiguous shard of the observation arrays, computes
partial segment reductions over its local observations, and `psum` over the
mesh combines the point/camera/global blocks over the device interconnect.
Parameters are replicated (points [P,3] is 24 MB at P=1e6 in f64 — cheap).
For point-axis sharding on the feature-major engine (shard-local point
reductions, psum-combined image partials) see parallel/spmd_fm.py — the
flagship multi-chip path.

Design per the survey's parallelism checklist (section 2.J): DP over
observation batches == per-device partial J^T W J with psum reduction; the
small reduced camera system is replicated.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.problem import ParamState
from . import rcs

AXIS = "obs"


def shard_problem(problem: rcs.RCSProblem, mesh: Mesh) -> rcs.RCSProblem:
    """Pad the observation arrays to a multiple of the mesh size (zero-weight
    pad rows) and device_put them sharded; tables are dropped (the SPMD path
    uses local segment reductions + psum)."""
    D = mesh.shape[AXIS]
    N = int(problem.obs_point.shape[0])
    Np = ((N + D - 1) // D) * D

    def pad(a, fill=0):
        a = np.asarray(a)
        if Np == N:
            return a
        out = np.full((Np,) + a.shape[1:], fill, a.dtype)
        out[:N] = a
        return out

    w = pad(problem.obs_weight)  # zero weight on pad rows

    def put(a, *spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))

    return problem._replace(
        obs_point=put(pad(problem.obs_point), AXIS),
        obs_image=put(pad(problem.obs_image), AXIS),
        obs_xy=put(pad(problem.obs_xy), AXIS, None),
        obs_weight=put(w, AXIS, None, None),
        point2obs=None,
        img2obs=None,
    )


@rcs._hi_prec
def make_spmd_lm_step(problem: rcs.RCSProblem, spec, mesh: Mesh,
                      cg_tol=1e-8, cg_maxiter=100):
    """Returns a jitted function state -> (new_state, max_dx, omega0, cg_it)
    running the full LM inner solve under shard_map.

    Inside the mapped function every device sees its local observation shard;
    `rcs.linearize` computes local partial blocks which are psum-combined.
    The PCG loop then runs redundantly on replicated reduced quantities with
    only the matvec's segment reductions requiring psum per iteration.
    """
    in_specs = (
        P(AXIS),  # obs_point
        P(AXIS),  # obs_image
        P(AXIS, None),  # obs_xy
        P(AXIS, None, None),  # obs_weight
        P(),  # state (replicated pytree handled via flat specs below)
    )

    def local_step(obs_point, obs_image, obs_xy, obs_weight, state):
        lp = problem._replace(obs_point=obs_point, obs_image=obs_image,
                              obs_xy=obs_xy, obs_weight=obs_weight)

        # --- linearise on local shard, psum the reduced blocks
        b = rcs.linearize(lp, state, spec, jnp.asarray(0.0, obs_xy.dtype))
        # Hpp_inv was computed from the *local* Hpp — recompute globally:
        # psum the pre-inverse pieces instead.
        # local Hpp (undo inverse): cheaper to re-reduce from scratch
        Hpp_loc = jnp.einsum("nia,nib->nab", b.Jp, b.PJp)
        Hpp = jax.lax.psum(
            jax.ops.segment_sum(Hpp_loc, obs_point,
                                num_segments=problem.num_points), AXIS)
        dpp = jnp.diagonal(Hpp, axis1=1, axis2=2)
        extra_p = (1.0 - problem.free_point)
        Hpp = Hpp + extra_p[:, :, None] * jnp.eye(3, dtype=Hpp.dtype)
        Hpp_inv = jnp.linalg.inv(Hpp)

        bp = jax.lax.psum(jax.ops.segment_sum(
            jnp.einsum("nia,nij,nj->na", b.Jp, b.P2, b.w), obs_point,
            num_segments=problem.num_points), AXIS)
        bc = jax.lax.psum(b.bc, AXIS)
        bg = jax.lax.psum(b.bg, AXIS)
        extra_c = 1.0 - problem.free_eo
        extra_g = 1.0 - problem.free_global
        omega0 = jax.lax.psum(b.omega0, AXIS)

        bg_blocks = b._replace(Hpp_inv=Hpp_inv, bp=bp, bc=bc, bg=bg,
                               extra_c=extra_c, extra_g=extra_g,
                               omega0=omega0)

        # --- implicit-Schur PCG; every segment reduction is local-shard
        # partial + psum (the point reduction must be global before the
        # Hpp^{-1} application, so the matvec is expanded inline)
        def matvec_spmd(xc, xg):
            t = jnp.einsum("nia,na->ni", bg_blocks.PJc, xc[obs_image])
            t = t + jnp.einsum("nia,a->ni", bg_blocks.PJg, xg)
            y = jax.lax.psum(jax.ops.segment_sum(
                jnp.einsum("nia,ni->na", bg_blocks.Jp, t), obs_point,
                num_segments=problem.num_points), AXIS)
            z = jnp.einsum("pab,pb->pa", Hpp_inv, y)
            u = jnp.einsum("nia,na->ni", bg_blocks.PJp, z[obs_point])
            tv = t - u
            oc = jax.lax.psum(jax.ops.segment_sum(
                jnp.einsum("nia,ni->na", bg_blocks.Jc, tv), obs_image,
                num_segments=problem.num_images), AXIS)
            og = jax.lax.psum(jnp.einsum("nia,ni->a", bg_blocks.Jg, tv), AXIS)
            return oc + extra_c * xc, og + extra_g * xg

        # rhs and preconditioner
        z0 = jnp.einsum("pab,pb->pa", Hpp_inv, bp)
        u0 = jnp.einsum("nia,na->ni", bg_blocks.PJp, z0[obs_point])
        rc = bc - jax.lax.psum(jax.ops.segment_sum(
            jnp.einsum("nia,ni->na", bg_blocks.Jc, u0), obs_image,
            num_segments=problem.num_images), AXIS)
        rg = bg - jax.lax.psum(
            jnp.einsum("nia,ni->a", bg_blocks.Jg, u0), AXIS)

        Hpc = jnp.einsum("nia,nib->nab", bg_blocks.Jp, bg_blocks.PJc)
        corr = jnp.einsum("nab,nac,ncd->nbd", Hpc, Hpp_inv[obs_point], Hpc)
        Scc = jax.lax.psum(jax.ops.segment_sum(
            jnp.einsum("nia,nib->nab", bg_blocks.Jc, bg_blocks.PJc) - corr,
            obs_image, num_segments=problem.num_images), AXIS)
        Scc = Scc + extra_c[:, :, None] * jnp.eye(6, dtype=Scc.dtype)
        Minv = jnp.linalg.inv(Scc)

        # exact global (IO/distortion) block of S (psum'd over shards)
        Hgg = jax.lax.psum(
            jnp.einsum("nia,nib->ab", bg_blocks.Jg, bg_blocks.PJg), AXIS
        ) + jnp.diag(extra_g)
        Hpg = jax.lax.psum(jax.ops.segment_sum(
            jnp.einsum("nia,nib->nab", bg_blocks.Jp, bg_blocks.PJg),
            obs_point, num_segments=problem.num_points), AXIS)
        Sgg = Hgg - jnp.einsum("pag,pab,pbh->gh", Hpg, Hpp_inv, Hpg)
        Minv_g = jnp.linalg.inv(Sgg)

        def apply_M(rc_, rg_):
            return jnp.einsum("mab,mb->ma", Minv, rc_), Minv_g @ rg_

        def dot(ac, ag, bc_, bg_):
            return jnp.sum(ac * bc_) + jnp.sum(ag * bg_)

        xc = jnp.zeros_like(rc)
        xg = jnp.zeros_like(rg)
        rcv, rgv = rc, rg
        zc, zg = apply_M(rcv, rgv)
        pc, pg = zc, zg
        rz = dot(rcv, rgv, zc, zg)
        r0n = jnp.sqrt(dot(rcv, rgv, rcv, rgv))

        def cond(carry):
            _, _, rcv_, rgv_, _, _, _, it = carry
            rn = jnp.sqrt(dot(rcv_, rgv_, rcv_, rgv_))
            return jnp.logical_and(it < cg_maxiter, rn > cg_tol * (1.0 + r0n))

        def body(carry):
            xc, xg, rcv, rgv, pc, pg, rz, it = carry
            qc, qg = matvec_spmd(pc, pg)
            alpha = rz / dot(pc, pg, qc, qg)
            xc = xc + alpha * pc
            xg = xg + alpha * pg
            rcv = rcv - alpha * qc
            rgv = rgv - alpha * qg
            zc, zg = apply_M(rcv, rgv)
            rz2 = dot(rcv, rgv, zc, zg)
            beta = rz2 / rz
            return (xc, xg, rcv, rgv, zc + beta * pc, zg + beta * pg,
                    rz2, it + 1)

        xc, xg, rcv, rgv, pc, pg, rz, it = jax.lax.while_loop(
            cond, body,
            (xc, xg, rcv, rgv, pc, pg, rz, jnp.zeros((), jnp.int32)))

        # back-substitute points (global reduction)
        t = jnp.einsum("nia,na->ni", bg_blocks.PJc, xc[obs_image])
        t = t + jnp.einsum("nia,a->ni", bg_blocks.PJg, xg)
        y = jax.lax.psum(jax.ops.segment_sum(
            jnp.einsum("nia,ni->na", bg_blocks.Jp, t), obs_point,
            num_segments=problem.num_points), AXIS)
        dxp = jnp.einsum("pab,pb->pa", Hpp_inv, bp - y)

        new_state, max_dx = rcs.apply_step(state, problem, dxp, xc, xg)
        return new_state, max_dx, omega0, it

    mapped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS, None), P(AXIS, None, None),
                  P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )

    # the sharded observation arrays are explicit jit arguments: in a
    # multi-controller (multi-host) run, closing over arrays spanning
    # non-addressable devices is not allowed
    @jax.jit
    def _step(obs_point, obs_image, obs_xy, obs_weight, state: ParamState):
        return mapped(obs_point, obs_image, obs_xy, obs_weight, state)

    def step(state: ParamState):
        return _step(problem.obs_point, problem.obs_image, problem.obs_xy,
                     problem.obs_weight, state)

    return step
