"""Free-network datum, scale bars and direct observations at scale.

The dense parity solver handles scale-bar rows
(PartialDerivativeFactory.java:210-283), directly observed parameters
(:447-473) and the Helmert inner-constraint rows of the free-network datum
(BundleAdjustment.java:493-635) inside one bordered normal-equation matrix.
At 100k..1M points that matrix cannot exist; this module folds all three
into the point-eliminated reduced camera system (parallel/rcs.py,
parallel/engine.py) *exactly*, without breaking the block-diagonal point
elimination:

* **Scale bars** add rank-1 rows u_s over two points.  With
  Hpp' = Hpp + U^T W U, Woodbury gives

      S' = Hxx - Hxp Hpp'^{-1} Hpx = S_base + Z Cap^{-1} Z^T,
      Z = Hxp (Hpp^{-1} U^T),  Cap = W^{-1} + U Hpp^{-1} U^T,

  i.e. an exact rank-S dense correction to the implicit Schur matvec —
  the per-chip kernels stay block-diagonal.

* **Inner constraints** (rows B over datum-point coordinates, normalised
  exactly as addDatumConditionRows) enter as KKT multipliers; eliminating
  points and then the multipliers yields

      (S' + Y Bb^{-1} Y^T) dx = r' + Y Bb^{-1} r_lam,
      Y = Hxp Hpp'^{-1} B^T,  Bb = B Hpp'^{-1} B^T,

  another exact rank-d (d <= 7) correction.  lambda and the point step are
  recovered afterwards; B dx = 0 holds like in the reference's bordered
  solve.

* **Direct observations** with diagonal weights are added natively into the
  block-diagonal structures by the linearisers (points -> Hpp/bp,
  EO -> extra_c/bc, IO/distortion -> extra_g/bg) before any elimination.

The corrections are computed against three layout-agnostic closures
(`PointOps`), so the block-layout rcs path and the feature-major engine
share this code.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# An f32 matmul without a stated precision may run in TF32 on the GPU; the
# big over-points contractions here pin full f32 precision.
_PREC = jax.lax.Precision.HIGHEST


class PointOps(NamedTuple):
    """Layout-agnostic operations on the linearised problem.

    hinv(v [P,3]) -> [P,3]        block-diagonal Hpp^{-1} v
    hinv_at(idx [k]) -> [k,3,3]   gathered Hpp^{-1} blocks
    hxp(v [P,3]) -> (c [M,6], g [G])   Hxp v (cams+globals rows)
    hpx(xc, xg) -> [P,3]          Hpx [xc; xg]
    """

    hinv: Callable
    hinv_at: Callable
    hxp: Callable
    hpx: Callable


class Extras(NamedTuple):
    """Per-linearisation correction data (all device arrays)."""

    z0_full: jnp.ndarray          # [P, 3] Hpp'^{-1} bp_full (stable form)
    rc: jnp.ndarray               # corrected reduced rhs (cams)
    rg: jnp.ndarray               # corrected reduced rhs (globals)
    # generalised point-row set (Q = bars + direct-dispersion rows)
    u_idx: jnp.ndarray | None     # [Q, 2] point ids per slot
    u_val: jnp.ndarray | None     # [Q, 2, 3] row values (+-unit / e_axis)
    v_val: jnp.ndarray | None     # [Q, 2, 3] Hpp^{-1}-applied rows
    w_s: jnp.ndarray | None       # [R] bar weights (bars only)
    w_sb: jnp.ndarray | None      # [Q] misclosures (bars then direct rows)
    Zc: jnp.ndarray | None        # [Q, M, 6]
    Zg: jnp.ndarray | None        # [Q, G]
    Cap_inv: jnp.ndarray | None   # [Q, Q]
    # inner constraints (d rows)
    Brows: jnp.ndarray | None     # [d, P, 3]
    Yc: jnp.ndarray | None        # [d, M, 6]
    Yg: jnp.ndarray | None        # [d, G]
    Bb_inv: jnp.ndarray | None    # [d, d]
    r_lam: jnp.ndarray | None     # [d]
    omega0: jnp.ndarray = None    # omega at linearisation incl. extras
    Cap: jnp.ndarray = None       # [Q, Q] (uninverted; wrap_precond)
    Bb: jnp.ndarray = None        # [d, d] (uninverted; wrap_precond)
    Wu_inv: jnp.ndarray = None    # [Q, Q] W^{-1} = blkdiag(1/w_bar, Sigma)


def datum_rows_dense(points, datum_mask, defect_flags):
    """Helmert inner-constraint rows as dense [d, P, 3] point-space vectors,
    normalised per row (addDatumConditionRows, BundleAdjustment.java:493-635;
    identical maths to ops/assembly._datum_rows without the column map)."""
    dtype = points.dtype
    m = datum_mask.astype(dtype)
    cnt = jnp.sum(m)
    cx = jnp.sum(points[:, 0] * m) / cnt
    cy = jnp.sum(points[:, 1] * m) / cnt
    cz = jnp.sum(points[:, 2] * m) / cnt
    x = (points[:, 0] - cx) * m
    y = (points[:, 1] - cy) * m
    z = (points[:, 2] - cz) * m
    zero = jnp.zeros_like(x)

    tx, ty, tz, rx, ry, rz, s = defect_flags
    rows = []
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
    if not rows:
        return None
    B = jnp.stack(rows)  # [d, P, 3]
    norms = jnp.sqrt(jnp.sum(B * B, axis=(1, 2)))
    return B / norms[:, None, None]


def _num_defects(defect_flags) -> int:
    return sum(1 for f in defect_flags if f)


def prepare_extras(problem, state, bp, rc, rg, ops: PointOps, omega0):
    """Build the exact low-rank corrections for the current linearisation.

    ``problem`` needs: sb_a/sb_b/sb_length/sb_weight (or None),
    dpg_idx/dpg_axis/dpg_val/dpg_cov (or None),
    datum_mask_d/defect_flags_d (or None), free_point.
    ``bp`` is the base reduced-point rhs [P, 3]; ``rc``/``rg`` the base
    reduced rhs; ``omega0`` the base Omega at the linearisation point.

    Scale bars and fully-populated direct-observation groups over point
    coordinates (DirectlyObservedParameterGroup.java:37-102 — the
    library's raison d'être, survey B6/E4) are folded as ONE generalised
    low-rank row set: each row touches <= 2 points (bars: the two
    endpoints; direct rows: one point, second slot zero), with the weight
    W = blkdiag(diag(w_bar), dpg_cov^{-1}) entering only through
    Cap = W^{-1} + U Hpp^{-1} U^T — the populated dispersion is used
    directly as its own W^{-1} block, never inverted.
    """
    p = problem
    P = p.num_points
    dtype = bp.dtype

    has_bars = getattr(p, "sb_a", None) is not None and p.sb_a.shape[0] > 0
    has_dpg = (getattr(p, "dpg_idx", None) is not None
               and p.dpg_idx.shape[0] > 0)
    flags = getattr(p, "defect_flags_d", None)
    d = _num_defects(flags) if flags is not None else 0

    u_idx = u_val = v_val = w_s = w_sb = Zc = Zg = Cap_inv = None
    Cap = Bb = Wu_inv = None
    Brows = Yc = Yg = Bb_inv = r_lam = None

    rows_idx, rows_val, winv_blocks, mis = [], [], [], []
    if has_bars:
        pa = state.points[p.sb_a]
        pb = state.points[p.sb_b]
        dvec = pb - pa
        dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=1))
        unit = dvec / dist[:, None]
        fa = p.free_point[p.sb_a]
        fb = p.free_point[p.sb_b]
        w_s = p.sb_weight.astype(dtype)
        w_bar = (p.sb_length - dist).astype(dtype)
        rows_idx.append(jnp.stack([p.sb_a, p.sb_b], axis=1))
        rows_val.append(jnp.stack([-unit * fa, unit * fb], axis=1))
        winv_blocks.append(jnp.diag(1.0 / w_s))
        mis.append(w_bar)
        omega0 = omega0 + jnp.sum(w_s * w_bar * w_bar)

    if has_dpg:
        pt = p.dpg_idx
        ax = p.dpg_axis
        cov = p.dpg_cov.astype(dtype)                       # [n, n] = W^{-1}
        e = (jax.nn.one_hot(ax, 3, dtype=dtype)
             * p.free_point[pt])                            # masked E rows
        cur = jnp.take_along_axis(state.points[pt], ax[:, None],
                                  axis=1)[:, 0]
        w_d = (p.dpg_val - cur).astype(dtype)
        rows_idx.append(jnp.stack([pt, pt], axis=1))
        rows_val.append(jnp.stack([e, jnp.zeros_like(e)], axis=1))
        winv_blocks.append(cov)
        mis.append(w_d)
        omega0 = omega0 + jnp.dot(w_d, jnp.linalg.solve(cov, w_d))

    has_rows = bool(rows_idx)
    if has_rows:
        u_idx = jnp.concatenate(rows_idx)                   # [Q, 2]
        u_val = jnp.concatenate(rows_val)                   # [Q, 2, 3]
        w_sb = jnp.concatenate(mis)                         # [Q]
        Q = u_idx.shape[0]
        Wu_inv = jnp.zeros((Q, Q), dtype)
        o = 0
        for blk in winv_blocks:
            n = blk.shape[0]
            Wu_inv = Wu_inv.at[o:o + n, o:o + n].set(blk)
            o += n

        # V = Hpp^{-1}-applied rows (same sparsity)
        Hinv_a = ops.hinv_at(u_idx[:, 0])
        Hinv_b = ops.hinv_at(u_idx[:, 1])
        v_val = jnp.stack([
            jnp.einsum("rab,rb->ra", Hinv_a, u_val[:, 0]),
            jnp.einsum("rab,rb->ra", Hinv_b, u_val[:, 1]),
        ], axis=1)

        # Cap = W^{-1} + U Hpp^{-1} U^T (rows share points -> slot match)
        match = (u_idx[:, :, None, None] == u_idx[None, None, :, :])
        dots = jnp.einsum("rlc,qmc->rlqm", u_val, v_val)
        gram = jnp.sum(jnp.where(match, dots, 0.0), axis=(1, 3))
        Cap = Wu_inv + gram
        Cap_inv = jnp.linalg.inv(Cap)

        # Z = Hxp (Hpp^{-1} U^T): one batched pass over observations
        def scatter_rows(idx, val):
            return jnp.zeros((P, 3), dtype).at[idx].add(val)

        Vrows = jax.vmap(scatter_rows)(u_idx, v_val)       # [Q, P, 3]
        Zc, Zg = jax.vmap(ops.hxp)(Vrows)                  # [Q, M, 6], [Q, G]

    if d > 0:
        Brows = datum_rows_dense(state.points, p.datum_mask_d, flags)
        Vb = jax.vmap(ops.hinv)(Brows)                      # [d, P, 3]
        Ybc, Ybg = jax.vmap(ops.hxp)(Vb)                    # [d, M, 6], [d, G]
        BB = jnp.einsum("kpa,qpa->kq", Brows, Vb,
                        precision=_PREC)                    # B Hpp^{-1} B^T

        if has_rows:
            # Xub[r, k] = U_r Hpp^{-1} B_k^T
            Vb_at_a = Vb[:, u_idx[:, 0], :]                 # [d, Q, 3]
            Vb_at_b = Vb[:, u_idx[:, 1], :]
            Xub = (jnp.einsum("rc,krc->rk", u_val[:, 0], Vb_at_a)
                   + jnp.einsum("rc,krc->rk", u_val[:, 1], Vb_at_b))
            CX = Cap_inv @ Xub                              # [Q, d]
            Yc = Ybc - jnp.einsum("rk,rmc->kmc", CX, Zc)
            Yg = Ybg - jnp.einsum("rk,rg->kg", CX, Zg)
            Bb = BB - Xub.T @ CX
        else:
            Yc, Yg = Ybc, Ybg
            Bb = BB
        Bb_inv = jnp.linalg.inv(Bb)

    # ---- corrected reduced rhs (f32-stable small-rank form) -----------
    # Never materialise bp_full = bp + U^T W w: the weight-amplified
    # endpoint spikes exceed f32 resolution and Hpp^{-1} (norm up to ~1e4
    # for weakly-conditioned points) blows the rounding into a point-step
    # error larger than the step (measured).  Instead carry
    # z0_full = Hpp'^{-1} bp_full, exactly:
    #   Hpp'^{-1} U^T W w = V Cap^{-1} w  (Woodbury identity, any SPD W)
    #   z0_full = hinv_rows(bp) + V Cap^{-1} (w - U hinv(bp))
    # — every operand is step-scaled, no cancelling large intermediates.
    z0 = ops.hinv(bp)
    if has_rows:
        uz0 = (jnp.einsum("rc,rc->r", u_val[:, 0], z0[u_idx[:, 0]])
               + jnp.einsum("rc,rc->r", u_val[:, 1], z0[u_idx[:, 1]]))
        coeff = Cap_inv @ (w_sb - uz0)
        z0_full = z0.at[u_idx[:, 0]].add(v_val[:, 0] * coeff[:, None])
        z0_full = z0_full.at[u_idx[:, 1]].add(v_val[:, 1] * coeff[:, None])
        # r' = bc - Hxp z0_full = rc_base - Zc coeff
        rc = rc - jnp.einsum("rmc,r->mc", Zc, coeff)
        rg = rg - jnp.einsum("rg,r->g", Zg, coeff)
    else:
        z0_full = z0

    if d > 0:
        # r_lam = B Hpp'^{-1} bp_full = B z0_full (stable: z0_full is
        # step-scaled, unlike the r_lam - Y^T x difference it replaces)
        r_lam = jnp.einsum("kpa,pa->k", Brows, z0_full, precision=_PREC)
        br = Bb_inv @ r_lam
        rc = rc + jnp.einsum("kmc,k->mc", Yc, br)
        rg = rg + jnp.einsum("kg,k->g", Yg, br)

    return Extras(z0_full=z0_full, rc=rc, rg=rg,
                  u_idx=u_idx, u_val=u_val, v_val=v_val, w_s=w_s, w_sb=w_sb,
                  Zc=Zc, Zg=Zg, Cap_inv=Cap_inv,
                  Brows=Brows, Yc=Yc, Yg=Yg, Bb_inv=Bb_inv, r_lam=r_lam,
                  omega0=omega0, Cap=Cap, Bb=Bb, Wu_inv=Wu_inv)


def wrap_matvec(base_matvec, ext: Extras):
    """S_tot @ x = S_base @ x + Z Cap^{-1} Z^T x + Y Bb^{-1} Y^T x."""
    def matvec(xc, xg):
        oc, og = base_matvec(xc, xg)
        if ext.Zc is not None:
            zt = (jnp.einsum("rmc,mc->r", ext.Zc, xc)
                  + jnp.einsum("rg,g->r", ext.Zg, xg))
            cz = ext.Cap_inv @ zt
            oc = oc + jnp.einsum("rmc,r->mc", ext.Zc, cz)
            og = og + jnp.einsum("rg,r->g", ext.Zg, cz)
        if ext.Yc is not None:
            yt = (jnp.einsum("kmc,mc->k", ext.Yc, xc)
                  + jnp.einsum("kg,g->k", ext.Yg, xg))
            by = ext.Bb_inv @ yt
            oc = oc + jnp.einsum("kmc,k->mc", ext.Yc, by)
            og = og + jnp.einsum("kg,k->g", ext.Yg, by)
        return oc, og

    return matvec


def wrap_precond(apply_M, ext: Extras):
    """Low-rank-corrected preconditioner apply (exact Woodbury fold of the
    extras corrections into the base preconditioner).

    The datum/bar corrections W C W^T (W = [Y Z], C = blkdiag(Bb^{-1},
    Cap^{-1})) carry the observation weight scale — their spectrum can sit
    orders of magnitude above S's typical eigenvalues, and a base
    preconditioner that ignores them leaves CG with a condition number that
    f32 cannot survive (measured: the f32 free-network step error exceeded
    the step itself).  Woodbury restores exactness on the correction
    subspace at the cost of q = d + R base-precondition applies at setup
    and one [q] solve per CG iteration:

        (M + W C W^T)^{-1} = M^{-1} - M^{-1} W A^{-1} W^T M^{-1},
        A = C^{-1} + W^T M^{-1} W,  C^{-1} = blkdiag(Bb, Cap).
    """
    cols_c, cols_g, cinv_blocks = [], [], []
    if ext.Yc is not None:
        cols_c.append(ext.Yc)
        cols_g.append(ext.Yg)
        cinv_blocks.append(ext.Bb if ext.Bb is not None
                           else jnp.linalg.inv(ext.Bb_inv))
    if ext.Zc is not None:
        cols_c.append(ext.Zc)
        cols_g.append(ext.Zg)
        cinv_blocks.append(ext.Cap if ext.Cap is not None
                           else jnp.linalg.inv(ext.Cap_inv))
    if not cols_c:
        return apply_M
    Wc = jnp.concatenate(cols_c)              # [q, M, 6]
    Wg = jnp.concatenate(cols_g)              # [q, G]
    q = Wc.shape[0]
    Cinv = jnp.zeros((q, q), Wc.dtype)
    o = 0
    for blk in cinv_blocks:
        n = blk.shape[0]
        Cinv = Cinv.at[o:o + n, o:o + n].set(blk)
        o += n
    MWc, MWg = jax.vmap(apply_M)(Wc, Wg)      # [q, M, 6], [q, G]
    A = Cinv + (jnp.einsum("qmc,rmc->qr", Wc, MWc, precision=_PREC)
                + jnp.einsum("qg,rg->qr", Wg, MWg, precision=_PREC))
    A_inv = jnp.linalg.inv(A)

    def apply_full(rc_, rg_):
        zc, zg = apply_M(rc_, rg_)
        t = (jnp.einsum("qmc,mc->q", Wc, zc)
             + jnp.einsum("qg,g->q", Wg, zg))
        at = A_inv @ t
        return (zc - jnp.einsum("qmc,q->mc", MWc, at),
                zg - jnp.einsum("qg,q->g", MWg, at))

    return apply_full


def _hinv_rows(ext: Extras, ops: PointOps, y):
    """Hpp'^{-1} y including the generalised-row Woodbury correction
    (bars + direct-dispersion rows)."""
    z = ops.hinv(y)
    if ext.Zc is not None:
        ia, ib = ext.u_idx[:, 0], ext.u_idx[:, 1]
        q = (jnp.einsum("rc,rc->r", ext.u_val[:, 0], z[ia])
             + jnp.einsum("rc,rc->r", ext.u_val[:, 1], z[ib]))
        s = ext.Cap_inv @ q
        z = z.at[ia].add(-ext.v_val[:, 0] * s[:, None])
        z = z.at[ib].add(-ext.v_val[:, 1] * s[:, None])
    return z


def back_substitute(problem, ext: Extras, ops: PointOps, xc, xg):
    """Recover (dx_p [P,3], lambda [d]) after the reduced solve.

    The multiplier is computed from the UNCONSTRAINED point step,
    Bb lam = B dxp0 with dxp0 = Hpp'^{-1} (bp_full - Hpx x) — algebraically
    identical to lam = Bb^{-1} (r_lam - Y^T x) (r_lam = B Hpp'^{-1} bp_full,
    Y^T x = B Hpp'^{-1} Hpx x) but numerically stable in f32: r_lam - Y^T x
    differences two large weight-scaled terms and Bb^{-1} amplifies the
    cancellation noise (measured: point-step error 10x the step itself);
    B dxp0 contracts small operands directly.  dxp0 itself reuses the
    stable z0_full = Hpp'^{-1} bp_full carried by `prepare_extras`."""
    dxp0 = ext.z0_full - _hinv_rows(ext, ops, ops.hpx(xc, xg))
    if ext.Yc is None:
        return dxp0, None
    bd = jnp.einsum("kpa,pa->k", ext.Brows, dxp0, precision=_PREC)
    lam = ext.Bb_inv @ bd
    corr = _hinv_rows(ext, ops,
                      jnp.einsum("kpa,k->pa", ext.Brows, lam))
    return dxp0 - corr, lam


def omega_extras(problem, ext: Extras, dxp):
    """Generalised-row (bars + direct-dispersion) contribution to Omega(dx)
    at the linearisation point (getOmega semantics: v = w - A dx;
    Omega += v^T W v with W = Wu_inv^{-1}, applied via a [Q] solve)."""
    if ext.u_val is None:
        return 0.0
    ia, ib = ext.u_idx[:, 0], ext.u_idx[:, 1]
    adx = (jnp.einsum("rc,rc->r", ext.u_val[:, 0], dxp[ia])
           + jnp.einsum("rc,rc->r", ext.u_val[:, 1], dxp[ib]))
    v = ext.w_sb - adx
    return jnp.dot(v, jnp.linalg.solve(ext.Wu_inv, v))
