"""Normal-equation assembly: N = A^T P A, n = A^T P w.

Array-native re-design of the reference's scalar stacking loop
(`derivation/PartialDerivativeFactory.stackNormalEquationSystem`,
PartialDerivativeFactory.java:475-505): instead of per-row scalar
scatter-adds, local per-observation blocks H = J^T P J [L, L] and
g = J^T P w [L] are computed batched (vmap over all image observations) and
scatter-added into the dense bordered system with one segment-reduce.  Fixed
parameters map to a dump row/column that is sliced away — the array analogue
of the reference's ``column == Integer.MAX_VALUE`` skip.

The bordered system layout matches the reference exactly: rows/cols 0..d-1
hold the (normalised) datum condition rows (`addDatumConditionRows`,
BundleAdjustment.java:493-635), the remaining u columns are the unknowns.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EPS
from ..models.problem import BundleProblem, ParamState
from .residuals import (
    image_point_jacobian,
    image_point_residual,
    image_weight_2x2,
    predict_image_point,
)


def _local_cols(problem: BundleProblem) -> np.ndarray:
    """Global column of every local parameter, per observation: [N, 12 + K]
    (order: point xyz, io, eo, distortion), -1 where fixed."""
    p = problem
    cams = p.cam_of_image[p.obs_image]
    return np.concatenate(
        [
            p.col_points[p.obs_point],  # [N, 3]
            p.col_io[cams],  # [N, 3]
            p.col_eo[p.obs_image],  # [N, 6]
            p.col_dist[cams],  # [N, K]
        ],
        axis=1,
    ).astype(np.int32)


def gather_local_params(state: ParamState, obs_point, obs_image, cam_of_image):
    """[N, 12 + K] local parameter vectors."""
    cams = cam_of_image[obs_image]
    return jnp.concatenate(
        [
            state.points[obs_point],
            state.io[cams],
            state.eo[obs_image],
            state.dist[cams],
        ],
        axis=1,
    )


def make_image_block_fn(problem: BundleProblem):
    """Returns fn(state) -> (J [N,2,L], w [N,2], P2 [N,2,2]) for all image
    observations (vmapped forward-AD of the collinearity + distortion model)."""
    spec = problem.spec
    obs_point = jnp.asarray(problem.obs_point)
    obs_image = jnp.asarray(problem.obs_image)
    cam_of_image = jnp.asarray(problem.cam_of_image)
    obs_xy = jnp.asarray(problem.obs_xy)
    obs_var = jnp.asarray(problem.obs_var)
    obs_rho = jnp.asarray(problem.obs_rho)
    r0_all = jnp.asarray(problem.r0)
    s2 = problem.sigma2_apriori

    def blocks(state: ParamState):
        from . import analytic as _analytic

        local = gather_local_params(state, obs_point, obs_image, cam_of_image)
        r0 = r0_all[cam_of_image[obs_image]]

        if _analytic.supports_spec(spec):
            J, w = jax.vmap(
                lambda loc, xy, r0_i:
                _analytic.analytic_image_jacobian_and_residual(
                    loc, xy, spec, r0_i)
            )(local, obs_xy, r0)
        else:
            def one(loc, r0_i, xy):
                pred = predict_image_point(loc, spec, r0_i)
                J = image_point_jacobian(loc, spec, r0_i)
                return J, xy - pred

            J, w = jax.vmap(one)(local, r0, obs_xy)
        P2 = jax.vmap(lambda vx, vy, rho: image_weight_2x2(vx, vy, rho, s2))(
            obs_var[:, 0], obs_var[:, 1], obs_rho
        )
        return J, w, P2

    return blocks


def make_assembler(problem: BundleProblem):
    """Returns fn(state, damping) -> (N [T,T], n [T], V [T]) building the full
    bordered, damped system plus the Jacobi preconditioner
    (createNormalEquation, BundleAdjustment.java:789-834).

    ``V`` is the diagonal preconditioner: 1/sqrt(diag N) where diag > EPS
    else 1 (:824-828).  Damping scales the diagonal of unknown columns
    multiplicatively: N_ii *= (1 + damping) (:814-822)."""
    p = problem
    T = p.total_size
    L = 12 + p.spec.num_coefficients
    cols_local = jnp.asarray(_local_cols(p))  # [N, L]
    blocks_fn = make_image_block_fn(p)

    sb_a = jnp.asarray(p.sb_a)
    sb_b = jnp.asarray(p.sb_b)
    sb_len = jnp.asarray(p.sb_length)
    sb_w = jnp.asarray(p.sigma2_apriori / p.sb_var) if p.num_scale_bars else None
    sb_cols = (
        jnp.concatenate([jnp.asarray(p.col_points[p.sb_a]),
                         jnp.asarray(p.col_points[p.sb_b])], axis=1)
        if p.num_scale_bars else None
    )  # [S, 6]

    datum_mask = jnp.asarray(p.datum_mask)
    col_datum = jnp.asarray(p.col_points)  # [P, 3]
    defect_flags = p.defect_flags
    d = p.defect

    def scatter_add_sym(N, n, H, g, cols):
        """Scatter local blocks into the dense system; cols -1 -> dump."""
        c = jnp.where(cols < 0, T, cols)  # [B, L]
        idx = c[:, :, None] * (T + 1) + c[:, None, :]
        N = N.reshape(-1).at[idx.reshape(-1)].add(H.reshape(-1)).reshape(T + 1, T + 1)
        n = n.at[c.reshape(-1)].add(g.reshape(-1))
        return N, n

    def assemble(state: ParamState, damping):
        dtype = state.points.dtype
        N = jnp.zeros((T + 1, T + 1), dtype)
        n = jnp.zeros(T + 1, dtype)

        # --- image observations
        J, w, P2 = blocks_fn(state)
        PJ = jnp.einsum("nij,njc->nic", P2, J)
        H = jnp.einsum("nir,nic->nrc", J, PJ)
        g = jnp.einsum("nic,ni->nc", PJ, w)
        N, n = scatter_add_sym(N, n, H, g, cols_local)

        # --- scale bars (unit-vector rows; PartialDerivativeFactory.java:210-283)
        if p.num_scale_bars:
            pa = state.points[sb_a]
            pb = state.points[sb_b]
            dvec = pb - pa
            dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=1))
            unit = dvec / dist[:, None]
            A = jnp.concatenate([-unit, unit], axis=1)  # [S, 6]
            wsb = sb_len - dist
            Hs = sb_w[:, None, None] * A[:, :, None] * A[:, None, :]
            gs = sb_w[:, None] * A * wsb[:, None]
            N, n = scatter_add_sym(N, n, Hs, gs, sb_cols)

        # --- directly observed parameters (identity rows)
        for dg in p.direct_groups:
            vals = _gather_direct(state, dg)
            wv = jnp.asarray(dg.values) - vals  # [n]
            W = jnp.asarray(dg.weight)
            c = jnp.where(jnp.asarray(dg.col) < 0, T, jnp.asarray(dg.col))
            idx = c[:, None] * (T + 1) + c[None, :]
            N = N.reshape(-1).at[idx.reshape(-1)].add(W.reshape(-1)).reshape(T + 1, T + 1)
            n = n.at[c].add(W @ wv)

        N = N[:T, :T]
        n = n[:T]

        # --- datum condition rows (bordered block, rows 0..d-1)
        if d > 0:
            B = _datum_rows(state.points, datum_mask, col_datum, defect_flags, d, T)
            N = N.at[:d, :].set(B)
            N = N.at[:, :d].set(B.T)

        # --- multiplicative LM damping on unknown diagonals (:814-822);
        # constraint rows have zero diagonal, unaffected.
        diag = jnp.diagonal(N)
        N = N + jnp.diag(diag * damping)

        # --- Jacobi preconditioner (:824-828)
        diag = jnp.diagonal(N)
        V = jnp.where(diag > EPS, 1.0 / jnp.sqrt(jnp.where(diag > EPS, diag, 1.0)), 1.0)
        return N, n, V

    return assemble


def _gather_direct(state: ParamState, dg):
    """Current values of the observed parameters of one direct group."""
    flat_blocks = [state.points.reshape(-1), state.io.reshape(-1),
                   state.dist.reshape(-1), state.eo.reshape(-1)]
    vals = jnp.stack([flat_blocks[int(k)][int(f)]
                      for k, f in zip(dg.kind, dg.flat)])
    return vals


def _datum_rows(points, datum_mask, col_points, defect_flags, d, T):
    """Helmert inner-constraint rows, normalised to unit length
    (addDatumConditionRows, BundleAdjustment.java:493-635).

    Returns B [d, T]; entries only in datum-point coordinate columns."""
    dtype = points.dtype
    m = datum_mask.astype(dtype)
    cnt = jnp.sum(m)
    cx = jnp.sum(points[:, 0] * m) / cnt
    cy = jnp.sum(points[:, 1] * m) / cnt
    cz = jnp.sum(points[:, 2] * m) / cnt
    x = (points[:, 0] - cx) * m
    y = (points[:, 1] - cy) * m
    z = (points[:, 2] - cz) * m

    tx, ty, tz, rx, ry, rz, s = defect_flags
    rows = []
    # per row: (values per point per component [P, 3])
    zero = jnp.zeros_like(x)
    if tx:
        rows.append(jnp.stack([m, zero, zero], axis=1))
    if ty:
        rows.append(jnp.stack([zero, m, zero], axis=1))
    if tz:
        rows.append(jnp.stack([zero, zero, m], axis=1))
    if rx:
        rows.append(jnp.stack([zero, z, -y], axis=1))
    if ry:
        rows.append(jnp.stack([-z, zero, x], axis=1))
    if rz:
        rows.append(jnp.stack([y, -x, zero], axis=1))
    if s:
        rows.append(jnp.stack([x, y, z], axis=1))

    B = jnp.zeros((d, T + 1), dtype)
    c = jnp.where(col_points < 0, T, col_points)  # [P, 3]
    for r, vals in enumerate(rows):
        norm = jnp.sqrt(jnp.sum(vals * vals))
        row = jnp.zeros(T + 1, dtype).at[c.reshape(-1)].add(vals.reshape(-1) / norm)
        B = B.at[r].set(row)
    return B[:, :T]


def make_omega_fn(problem: BundleProblem):
    """Returns fn(state, dx_full) -> Omega = sum v^T P v with
    v = w - A dx (getOmega, BundleAdjustment.java:472-491), evaluated at the
    state's linearisation point."""
    p = problem
    T = p.total_size
    cols_local = jnp.asarray(_local_cols(p))
    blocks_fn = make_image_block_fn(p)

    sb_a = jnp.asarray(p.sb_a)
    sb_b = jnp.asarray(p.sb_b)
    sb_len = jnp.asarray(p.sb_length)
    sb_w = jnp.asarray(p.sigma2_apriori / p.sb_var) if p.num_scale_bars else None
    sb_cols = (
        jnp.concatenate([jnp.asarray(p.col_points[p.sb_a]),
                         jnp.asarray(p.col_points[p.sb_b])], axis=1)
        if p.num_scale_bars else None
    )

    def omega(state: ParamState, dx_full):
        dxp = jnp.concatenate([dx_full, jnp.zeros(1, dx_full.dtype)])  # dump=0

        J, w, P2 = blocks_fn(state)
        dx_loc = dxp[jnp.where(cols_local < 0, T, cols_local)]  # [N, L]
        v = w - jnp.einsum("nic,nc->ni", J, dx_loc)
        om = jnp.sum(jnp.einsum("ni,nij,nj->n", v, P2, v))

        if p.num_scale_bars:
            pa = state.points[sb_a]
            pb = state.points[sb_b]
            dvec = pb - pa
            dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=1))
            unit = dvec / dist[:, None]
            A = jnp.concatenate([-unit, unit], axis=1)
            wsb = sb_len - dist
            dx_loc = dxp[jnp.where(sb_cols < 0, T, sb_cols)]
            v = wsb - jnp.sum(A * dx_loc, axis=1)
            om = om + jnp.sum(sb_w * v * v)

        for dg in p.direct_groups:
            vals = _gather_direct(state, dg)
            wv = jnp.asarray(dg.values) - vals
            dx_loc = dxp[jnp.where(jnp.asarray(dg.col) < 0, T, jnp.asarray(dg.col))]
            v = wv - dx_loc
            om = om + v @ jnp.asarray(dg.weight) @ v

        return om

    return omega
