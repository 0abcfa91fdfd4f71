"""Large-scale LM solver: point-eliminated reduced camera system (RCS)
with implicit-Schur preconditioned conjugate gradients.

The dense bordered solver (solver/adjustment.py) materialises N [u x u] and
is the parity path for metrology-sized networks (10^2..10^3 points, full
posterior dispersion).  At the driver's north-star scale (100k..1M points,
BASELINE.json configs 4-5) u is 3e5..3e6 and the dense system cannot exist;
the block structure of the bundle Hessian is exploited instead:

    H = | Hpp  Hpc  Hpg |     Hpp: [P,3,3] block-diagonal (points)
        | .    Hcc  Hcg |     Hcc: [M,6,6] block-diagonal (cameras/EO)
        | .    .    Hgg |     Hgg: [G,G]   small global block (IO+distortion)

Eliminating the points gives the reduced camera system over x = (cams, glob)

    S x = rhs,   S = Hxx - Hxp Hpp^{-1} Hpx,
    rhs = bx - Hxp Hpp^{-1} bp

whose matrix-vector product is computed *implicitly* from per-observation
Jacobian blocks with segment-sums — O(N_obs) per product, S never
materialised — and solved by PCG with an exact block-Jacobi preconditioner
(6x6 per camera).  This is the array-native inversion of the reference's
per-image Schur loop (BundleAdjustment.java:1197-1342): eliminate the big
block (points), iterate on the small one.

All control flow is lax.while_loop under jit; the observation axis is the
data-parallel sharding axis (with obs arrays sharded over a mesh, XLA lowers
the segment-sums to per-device partials + all-reduces between devices).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.problem import ParamState
from ..ops.assembly import gather_local_params
from ..ops.residuals import image_point_jacobian, image_weight_2x2, predict_image_point


class RCSProblem(NamedTuple):
    """Static arrays of the large-scale problem (device arrays).

    Datum: minimal constraints via fixed coordinates (free_* masks), the
    standard production choice at this scale; inner (Helmert) constraints are
    the dense solver's domain.
    """

    obs_point: jnp.ndarray  # [N] int32
    obs_image: jnp.ndarray  # [N] int32
    cam_of_image: jnp.ndarray  # [M] int32
    obs_xy: jnp.ndarray  # [N, 2]
    obs_weight: jnp.ndarray  # [N, 2, 2] (already includes validity mask)
    r0: jnp.ndarray  # [C]
    num_points: int
    num_images: int
    free_point: jnp.ndarray  # [P, 3] 1.0 = free, 0.0 = fixed
    free_eo: jnp.ndarray  # [M, 6]
    free_global: jnp.ndarray  # [G] with G = C * (3 + K)
    # Optional dense visibility tables (gather-based reductions).  A
    # scatter serialises on colliding indices, so per-image segment-sums of
    # ~N/M rows each can dominate the hot loop; with these tables every
    # reduction becomes gather + dense sum (no scatter in the CG loop).
    # Entries == N point at an implicit zero pad row.
    point2obs: jnp.ndarray | None = None  # [P, Kp] int32
    img2obs: jnp.ndarray | None = None  # [M, Kc] int32
    # Optional blocked image-reduction layout (preferred): a static
    # permutation into image-sorted order padded per image to a multiple of
    # IMG_BLOCK, followed by within-block sums and a short cumsum-diff over
    # block boundaries — no scatter, f32-safe two-level summation.
    img_perm: jnp.ndarray | None = None  # [Nip] int32 (N -> zero pad row)
    img_block_starts: jnp.ndarray | None = None  # [M+1] int32 (block units)
    # When the observations are stored point-major with a uniform number of
    # views per point, per-point reductions are pure reshapes (static int).
    point_uniform: int | None = None
    # ---- free-network extensions (parallel/freenet.py) ----
    # scale bars (PartialDerivativeFactory.java:210-283): rank-1 rows over
    # two points, folded into the reduced system via Woodbury
    sb_a: jnp.ndarray | None = None       # [S] int32
    sb_b: jnp.ndarray | None = None       # [S] int32
    sb_length: jnp.ndarray | None = None  # [S]
    sb_weight: jnp.ndarray | None = None  # [S] sigma0^2 / sigma_s^2
    # Helmert inner constraints (BundleAdjustment.java:493-635)
    datum_mask_d: jnp.ndarray | None = None  # [P] 1.0 = datum point
    defect_flags_d: tuple | None = None      # 7 bools (tx ty tz rx ry rz s)
    # directly observed parameters with diagonal weights
    # (PartialDerivativeFactory.java:447-473); weight 0 = not observed
    dp_w: jnp.ndarray | None = None    # [P, 3]
    dp_val: jnp.ndarray | None = None  # [P, 3]
    de_w: jnp.ndarray | None = None    # [M, 6]
    de_val: jnp.ndarray | None = None  # [M, 6]
    dg_w: jnp.ndarray | None = None    # [G]
    dg_val: jnp.ndarray | None = None  # [G]
    # directly observed POINT coordinates with a fully populated dispersion
    # (DirectlyObservedParameterGroup.java:37-102): n observed coordinates
    # (point, axis) with covariance block dpg_cov = Sigma / sigma0^2 = W^{-1}
    # — folded into the reduced system as exact low-rank rows
    # (parallel/freenet.py)
    dpg_idx: jnp.ndarray | None = None   # [n] int32 point ids
    dpg_axis: jnp.ndarray | None = None  # [n] int32 axis (0/1/2)
    dpg_val: jnp.ndarray | None = None   # [n] observed values
    dpg_cov: jnp.ndarray | None = None   # [n, n] Sigma / sigma0^2

    @property
    def has_extras(self) -> bool:
        """Scale bars, inner constraints or full-dispersion direct groups
        present (lm_step_full path)."""
        return ((self.sb_a is not None and int(self.sb_a.shape[0]) > 0)
                or (self.defect_flags_d is not None
                    and any(self.defect_flags_d))
                or (self.dpg_idx is not None
                    and int(self.dpg_idx.shape[0]) > 0))


class Blocks(NamedTuple):
    Jp: jnp.ndarray  # [N, 2, 3]
    Jc: jnp.ndarray  # [N, 2, 6]
    Jg: jnp.ndarray  # [N, 2, G]
    PJp: jnp.ndarray  # [N, 2, 3]  P-weighted blocks (precomputed for the
    PJc: jnp.ndarray  # [N, 2, 6]  CG hot loop)
    PJg: jnp.ndarray  # [N, 2, G]
    P2: jnp.ndarray  # [N, 2, 2]
    w: jnp.ndarray  # [N, 2]
    Hpp_inv: jnp.ndarray  # [P, 3, 3]
    bp: jnp.ndarray  # [P, 3]
    bc: jnp.ndarray  # [M, 6]
    bg: jnp.ndarray  # [G]
    extra_c: jnp.ndarray  # [M, 6] diagonal damping/fixed additions
    extra_g: jnp.ndarray  # [G]
    omega0: jnp.ndarray  # scalar: w^T P w at the linearisation point
    # misclosures of directly observed parameters (None when absent)
    w_dp: jnp.ndarray | None = None  # [P, 3]
    w_de: jnp.ndarray | None = None  # [M, 6]
    w_dg: jnp.ndarray | None = None  # [G]


def _hi_prec(fn):
    """Pin full-f32 matmul precision for everything traced inside ``fn``.

    An f32 dot without a stated precision may run in TF32 on the GPU
    (about three decimal digits); the block-layout einsums here are
    normal-equation / Schur products where that silently degrades the
    step.  jax.default_matmul_precision("highest") covers every einsum/dot
    without an explicit precision= in the traced call tree;
    explicitly-pinned products (tp.py) are unaffected.

    Deliberately NOT applied to `pcg` / `finish_coupling`: their small
    preconditioner products keep the backend default (see
    `_EXACT_APPLY`).  The big per-observation contractions
    (linearize/prepare/matvec) are where reduced precision loses accuracy
    AND where HIGHEST is safe."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **k)
    return wrapped


def _seg(x, ids, num):
    return jax.ops.segment_sum(x, ids, num_segments=num)


def _seg_point(p: "RCSProblem", x):
    """Sum per point: reshape (uniform point-major) > gather table >
    segment_sum."""
    if p.point_uniform is not None:
        return x.reshape((p.num_points, p.point_uniform) + x.shape[1:]).sum(1)
    if p.point2obs is None:
        return _seg(x, p.obs_point, p.num_points)
    xp = jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)])
    return jnp.sum(xp[p.point2obs], axis=1)


def _expand_point(p: "RCSProblem", z):
    """Gather per-point values back to observations: z[obs_point], using a
    broadcast when the layout is uniform point-major."""
    if p.point_uniform is not None:
        shape = (p.num_points, p.point_uniform) + z.shape[1:]
        return jnp.broadcast_to(z[:, None], shape).reshape(
            (p.num_points * p.point_uniform,) + z.shape[1:])
    return z[p.obs_point]


#: block size of the image-sorted blocked reduction (lane-friendly)
IMG_BLOCK = 512


def _seg_image(p: "RCSProblem", x):
    """Sum per image.  Preference order: blocked permutation layout
    (scatter-free, precision-safe) > gather table > segment_sum."""
    if p.img_perm is not None:
        flat = x.reshape(x.shape[0], -1)
        xp = jnp.concatenate([flat, jnp.zeros((1, flat.shape[1]), x.dtype)])
        xi = xp[p.img_perm]  # [Nip, F]
        nb = xi.shape[0] // IMG_BLOCK
        bl = xi.reshape(nb, IMG_BLOCK, -1).sum(axis=1)  # [Nb, F]
        cs = jnp.cumsum(bl, axis=0)
        csz = jnp.concatenate([jnp.zeros((1, bl.shape[1]), x.dtype), cs])
        out = csz[p.img_block_starts[1:]] - csz[p.img_block_starts[:-1]]
        return out.reshape((p.num_images,) + x.shape[1:])
    if p.img2obs is None:
        return _seg(x, p.obs_image, p.num_images)
    xp = jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)])
    return jnp.sum(xp[p.img2obs], axis=1)


def build_image_block_layout(obs_image, num_images, block=IMG_BLOCK):
    """Host-side: permutation into image-sorted order with per-image padding
    to a multiple of `block`; returns (img_perm [Nip], img_block_starts
    [M+1] in block units)."""
    import numpy as np

    obs_image = np.asarray(obs_image)
    N = obs_image.shape[0]
    order = np.argsort(obs_image, kind="stable")
    counts = np.bincount(obs_image, minlength=num_images)
    padded = ((counts + block - 1) // block) * block
    # images with zero observations still get zero padded blocks (padded=0)
    starts = np.concatenate([[0], np.cumsum(padded)])
    perm = np.full(int(starts[-1]), N, np.int32)
    src = 0
    for m in range(num_images):
        c = int(counts[m])
        perm[starts[m]:starts[m] + c] = order[src:src + c]
        src += c
    return perm, (starts // block).astype(np.int32)


def build_visibility_tables(obs_point, obs_image, num_points, num_images):
    """Host-side construction of the dense gather tables (numpy)."""
    import numpy as np

    obs_point = np.asarray(obs_point)
    obs_image = np.asarray(obs_image)
    N = obs_point.shape[0]

    def table(ids, num):
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        counts = np.bincount(ids, minlength=num)
        K = int(counts.max()) if num else 0
        t = np.full((num, K), N, np.int32)
        # position of each obs within its segment
        pos = np.arange(N) - np.concatenate([[0], np.cumsum(counts)])[sorted_ids]
        t[sorted_ids, pos] = order
        return t

    return table(obs_point, num_points), table(obs_image, num_images)


def rcs_from_problem(bp, dtype=jnp.float64, build_tables: bool = True) -> RCSProblem:
    """Build an RCSProblem from a compiled dense BundleProblem.  Scale bars,
    the free-network (inner-constraint) datum and ALL direct observations
    are carried over: diagonal-weight observations fold natively into the
    block structures; groups with a fully populated dispersion over point
    coordinates become exact low-rank rows (parallel/freenet.py).  A
    populated dispersion over IO/EO/distortion parameters remains the
    dense solver's domain (those blocks live in the retained system; the
    point-coordinate case is the reference's flagship use,
    ExampleFlatFiles.java:129-141)."""
    import numpy as np

    w2 = jax.vmap(image_weight_2x2)(
        jnp.asarray(bp.obs_var[:, 0], dtype), jnp.asarray(bp.obs_var[:, 1], dtype),
        jnp.asarray(bp.obs_rho, dtype),
        jnp.full(bp.num_image_obs, bp.sigma2_apriori, dtype))
    C = bp.num_cameras
    K = bp.spec.num_coefficients
    free_global = np.concatenate(
        [np.concatenate([(bp.col_io[c] >= 0), (bp.col_dist[c] >= 0)])
         for c in range(C)]).astype(float)
    p2o = i2o = None
    if build_tables:
        p2o, i2o = build_visibility_tables(
            bp.obs_point, bp.obs_image, bp.num_points, bp.num_images)
        p2o = jnp.asarray(p2o)
        i2o = jnp.asarray(i2o)

    # scale bars
    sb = {}
    if bp.num_scale_bars:
        sb = dict(sb_a=jnp.asarray(bp.sb_a), sb_b=jnp.asarray(bp.sb_b),
                  sb_length=jnp.asarray(bp.sb_length, dtype),
                  sb_weight=jnp.asarray(bp.sigma2_apriori / bp.sb_var, dtype))

    # free-network datum
    datum = {}
    if bp.defect > 0:
        datum = dict(datum_mask_d=jnp.asarray(bp.datum_mask.astype(float), dtype),
                     defect_flags_d=tuple(bp.defect_flags))

    # directly observed parameters (diagonal weights)
    direct = {}
    if bp.direct_groups:
        G = C * (3 + K)
        dp_w = np.zeros((bp.num_points, 3))
        dp_val = np.zeros((bp.num_points, 3))
        de_w = np.zeros((bp.num_images, 6))
        de_val = np.zeros((bp.num_images, 6))
        dg_w = np.zeros(G)
        dg_val = np.zeros(G)
        dpg_idx, dpg_axis, dpg_val_l, dpg_cov_blocks = [], [], [], []
        for dg in bp.direct_groups:
            if not dg.diagonal:
                if not (dg.kind == 0).all():
                    raise ValueError(
                        "fully populated direct-observation dispersion over "
                        "IO/EO/distortion parameters is the dense solver's "
                        "domain (DirectlyObservedParameterGroup.java:67-92); "
                        "at scale only point-coordinate groups are supported")
                # weight = sigma0^2 Sigma^{-1}; freenet consumes W^{-1}
                dpg_idx.append(dg.flat // 3)
                dpg_axis.append(dg.flat % 3)
                dpg_val_l.append(dg.values)
                dpg_cov_blocks.append(np.linalg.inv(dg.weight))
                continue
            wdiag = np.diagonal(dg.weight)
            for kind, flat, wv, val in zip(dg.kind, dg.flat, wdiag, dg.values):
                if kind == 0:
                    dp_w.flat[flat] += wv
                    dp_val.flat[flat] = val
                elif kind == 3:
                    de_w.flat[flat] += wv
                    de_val.flat[flat] = val
                elif kind == 1:  # io: per-camera global slot
                    c, k = divmod(int(flat), 3)
                    g = c * (3 + K) + k
                    dg_w[g] += wv
                    dg_val[g] = val
                else:  # dist
                    c, k = divmod(int(flat), K)
                    g = c * (3 + K) + 3 + k
                    dg_w[g] += wv
                    dg_val[g] = val
        if dp_w.any():
            direct.update(dp_w=jnp.asarray(dp_w, dtype),
                          dp_val=jnp.asarray(dp_val, dtype))
        if de_w.any():
            direct.update(de_w=jnp.asarray(de_w, dtype),
                          de_val=jnp.asarray(de_val, dtype))
        if dg_w.any():
            direct.update(dg_w=jnp.asarray(dg_w, dtype),
                          dg_val=jnp.asarray(dg_val, dtype))
        if dpg_idx:
            n_tot = sum(len(i) for i in dpg_idx)
            cov = np.zeros((n_tot, n_tot))
            o = 0
            for blk in dpg_cov_blocks:
                n = blk.shape[0]
                cov[o:o + n, o:o + n] = blk
                o += n
            direct.update(
                dpg_idx=jnp.asarray(np.concatenate(dpg_idx), jnp.int32),
                dpg_axis=jnp.asarray(np.concatenate(dpg_axis), jnp.int32),
                dpg_val=jnp.asarray(np.concatenate(dpg_val_l), dtype),
                dpg_cov=jnp.asarray(cov, dtype))

    return RCSProblem(
        point2obs=p2o,
        img2obs=i2o,
        obs_point=jnp.asarray(bp.obs_point),
        obs_image=jnp.asarray(bp.obs_image),
        cam_of_image=jnp.asarray(bp.cam_of_image),
        obs_xy=jnp.asarray(bp.obs_xy, dtype),
        obs_weight=w2,
        r0=jnp.asarray(bp.r0, dtype),
        num_points=bp.num_points,
        num_images=bp.num_images,
        free_point=jnp.asarray((bp.col_points >= 0).astype(float), dtype),
        free_eo=jnp.asarray((bp.col_eo >= 0).astype(float), dtype),
        free_global=jnp.asarray(free_global, dtype),
        **sb, **datum, **direct,
    )


@_hi_prec
def linearize(problem: RCSProblem, state: ParamState, spec, damping,
              skip_image_reductions: bool = False) -> Blocks:
    p = problem
    P_, M_ = p.num_points, p.num_images
    local = gather_local_params(state, p.obs_point, p.obs_image, p.cam_of_image)
    cams = p.cam_of_image[p.obs_image]
    r0 = p.r0[cams]

    from ..ops import analytic as _analytic

    if _analytic.supports_spec(spec):
        # closed-form rows: far smaller compiled program than jacfwd
        J, w = jax.vmap(
            lambda loc, xy, r0_i:
            _analytic.analytic_image_jacobian_and_residual(loc, xy, spec, r0_i)
        )(local, p.obs_xy, r0)
    else:
        def one(loc, r0_i, xy):
            pred = predict_image_point(loc, spec, r0_i)
            J = image_point_jacobian(loc, spec, r0_i)
            return J, xy - pred

        J, w = jax.vmap(one)(local, r0, p.obs_xy)
    P2 = p.obs_weight

    # fixed parameters: mask Jacobian columns (array analogue of the
    # reference's column == MAX_VALUE skip)
    Jp = J[:, :, 0:3] * p.free_point[p.obs_point][:, None, :]
    Jc = J[:, :, 6:12] * p.free_eo[p.obs_image][:, None, :]

    C = state.io.shape[0]
    K = J.shape[2] - 12
    Gpc = 3 + K
    G = C * Gpc
    Jg_cam = jnp.concatenate([J[:, :, 3:6], J[:, :, 12:]], axis=2)  # [N,2,Gpc]

    if C == 1:
        Jg = Jg_cam
    else:
        offs = cams * Gpc

        def to_full(jg, off):
            z = jnp.zeros((2, G), jg.dtype)
            return jax.lax.dynamic_update_slice(
                z, jg, (jnp.zeros((), off.dtype), off))

        Jg = jax.vmap(to_full)(Jg_cam, offs)
    Jg = Jg * p.free_global[None, None, :]

    Pw = jnp.einsum("nij,nj->ni", P2, w)
    omega0 = jnp.sum(w * Pw)

    PJp = jnp.einsum("nij,nja->nia", P2, Jp)
    PJc = jnp.einsum("nij,nja->nia", P2, Jc)
    PJg = jnp.einsum("nij,nja->nia", P2, Jg)

    eye3 = jnp.eye(3, dtype=J.dtype)
    Hpp = _seg_point(p, jnp.einsum("nia,nib->nab", Jp, PJp))
    dpp = jnp.diagonal(Hpp, axis1=1, axis2=2)
    extra_p = damping * dpp + (1.0 - p.free_point)
    bp = _seg_point(p, jnp.einsum("nia,ni->na", Jp, Pw))

    # directly observed point coordinates (diagonal weights): identity rows
    # add W into the damped diagonal and W (obs - x) into the rhs
    # (PartialDerivativeFactory.java:447-473; damping multiplies the full
    # assembled diagonal, BundleAdjustment.java:814-822)
    w_dp = w_de = w_dg = None
    if p.dp_w is not None:
        w_dp = p.dp_val - state.points
        wp = p.dp_w * p.free_point
        extra_p = extra_p + wp * (1.0 + damping)
        bp = bp + wp * w_dp
        omega0 = omega0 + jnp.sum(p.dp_w * w_dp * w_dp)
    Hpp = Hpp + extra_p[:, :, None] * eye3
    Hpp_inv = jnp.linalg.inv(Hpp)

    if skip_image_reductions:
        # bc / extra_c are produced by prepare()'s fused reduction
        extra_c = jnp.zeros((M_, 6), J.dtype)
        bc = jnp.zeros((M_, 6), J.dtype)
    else:
        Hcc_diag = _seg_image(p, jnp.einsum("nia,nib->nab", Jc, PJc))
        extra_c = (damping * jnp.diagonal(Hcc_diag, axis1=1, axis2=2)
                   + (1.0 - p.free_eo))
        bc = _seg_image(p, jnp.einsum("nia,ni->na", Jc, Pw))
        if p.de_w is not None:
            w_de = p.de_val - state.eo
            we = p.de_w * p.free_eo
            extra_c = extra_c + we * (1.0 + damping)
            bc = bc + we * w_de

    if p.de_w is not None:
        w_de = p.de_val - state.eo
        omega0 = omega0 + jnp.sum(p.de_w * w_de * w_de)

    Hgg_diag = jnp.einsum("nia,nia->a", Jg, PJg)
    extra_g = damping * Hgg_diag + (1.0 - p.free_global)
    bg = jnp.einsum("nia,ni->a", Jg, Pw)
    if p.dg_w is not None:
        C_ = state.io.shape[0]
        gvec = jnp.concatenate([state.io, state.dist], axis=1).reshape(-1)
        w_dg = p.dg_val - gvec
        wg = p.dg_w * p.free_global
        extra_g = extra_g + wg * (1.0 + damping)
        bg = bg + wg * w_dg
        omega0 = omega0 + jnp.sum(p.dg_w * w_dg * w_dg)

    return Blocks(Jp=Jp, Jc=Jc, Jg=Jg, PJp=PJp, PJc=PJc, PJg=PJg, P2=P2, w=w,
                  Hpp_inv=Hpp_inv, bp=bp, bc=bc, bg=bg, extra_c=extra_c,
                  extra_g=extra_g, omega0=omega0,
                  w_dp=w_dp, w_de=w_de, w_dg=w_dg)


@_hi_prec
def schur_matvec(p: RCSProblem, b: Blocks, xc, xg):
    """Implicit S @ [xc; xg]; every term is O(N_obs), gathers + dense sums
    only (no scatter) when the visibility tables are present."""
    # t = P (Jc xc + Jg xg) per observation [N, 2]
    t = jnp.einsum("nia,na->ni", b.PJc, xc[p.obs_image])
    t = t + jnp.einsum("nia,a->ni", b.PJg, xg)

    # z = Hpp^{-1} Hpx x  (gathered back per obs)
    y = _seg_point(p, jnp.einsum("nia,ni->na", b.Jp, t))
    z = jnp.einsum("pab,pb->pa", b.Hpp_inv, y)
    u = jnp.einsum("nia,na->ni", b.PJp, _expand_point(p, z))

    tv = t - u
    out_c = _seg_image(p, jnp.einsum("nia,ni->na", b.Jc, tv))
    out_c = out_c + b.extra_c * xc
    out_g = jnp.einsum("nia,ni->a", b.Jg, tv) + b.extra_g * xg
    return out_c, out_g


@_hi_prec
def reduced_rhs(p: RCSProblem, b: Blocks):
    """rhs = bx - Hxp Hpp^{-1} bp."""
    z0 = jnp.einsum("pab,pb->pa", b.Hpp_inv, b.bp)
    u0 = jnp.einsum("nia,na->ni", b.PJp, _expand_point(p, z0))
    rc = b.bc - _seg_image(p, jnp.einsum("nia,ni->na", b.Jc, u0))
    rg = b.bg - jnp.einsum("nia,ni->a", b.Jg, u0)
    return rc, rg


@_hi_prec
def camera_block_preconditioner(p: RCSProblem, b: Blocks):
    """Exact 6x6 diagonal blocks of S (one observation per (point, image)
    pair makes the per-image correction exact): used as block-Jacobi."""
    Hpc = jnp.einsum("nia,nib->nab", b.Jp, b.PJc)  # [N, 3, 6]
    corr = jnp.einsum("nab,nac,ncd->nbd", Hpc, _expand_point(p, b.Hpp_inv), Hpc)
    Scc = _seg_image(p, jnp.einsum("nia,nib->nab", b.Jc, b.PJc) - corr)
    Scc = Scc + b.extra_c[:, :, None] * jnp.eye(6, dtype=Scc.dtype)
    return jnp.linalg.inv(Scc)


#: trace-time switch: apply the preconditioner blocks with elementwise
#: multiply-sums (exact f32) instead of default-precision einsums.  An
#: einsum at the backend's default f32 precision may round through a
#: reduced-precision matmul (TF32 on the GPU); for mid-conditioned solves
#: (same-problem dryrun, damping 1e-3) that can leave CG unable to
#: converge, while for the deep refinement solves the rounding has acted
#: as a regulariser — the exact apply surfaces tiny negative f32
#: eigenvalues of the reduced operator and CG breaks down (CPU f32 is
#: fine either way).  Flagship solves keep the einsum default;
#: cross-engine agreement checks enable `exact_preconditioner()` around
#: their traces.
_EXACT_APPLY = False


class exact_preconditioner:
    """Context manager: trace enclosed solves with the exact (elementwise)
    preconditioner apply — see `_EXACT_APPLY`."""

    def __enter__(self):
        global _EXACT_APPLY
        self._old = _EXACT_APPLY
        _EXACT_APPLY = True
        return self

    def __exit__(self, *exc):
        global _EXACT_APPLY
        _EXACT_APPLY = self._old
        return False


class Precond(NamedTuple):
    """Block preconditioner of the reduced system: exact 6x6 camera blocks
    plus the exact (small, dense) global IO/distortion block.  The global
    block couples every observation; leaving it unpreconditioned costs ~5x
    in CG iterations (measured: 375 -> 78 to 1e-5 at 20k points).

    When ``Scg``/``W``/``Sghat_inv`` are set (see `couple_preconditioner`)
    the preconditioner additionally carries the exact camera-global
    off-diagonal blocks and is applied exactly via a Schur complement on
    the (small) global block:

        M = [[D, Scg], [Scg^T, Sgg]],  D = blockdiag(Scc_m)
        u  = D^{-1} rc
        zg = (Sgg - Scg^T D^{-1} Scg)^{-1} (rg - Scg^T u)
        zc = u - (D^{-1} Scg) zg

    i.e. only the camera-camera coupling *through points* is dropped, at
    a setup cost of G extra matvecs; at the 100k-point bench size it
    saves several times that in CG iterations."""

    Minv_c: jnp.ndarray  # [M, 6, 6]
    Minv_g: jnp.ndarray  # [G, G]
    Scg: jnp.ndarray | None = None        # [M, 6, G]
    W: jnp.ndarray | None = None          # [M, 6, G]  (= D^{-1} Scg)
    Sghat_inv: jnp.ndarray | None = None  # [G, G]


def finish_coupling(Minv: Precond, Scg, Sgg, axis_cam: str | None = None) \
        -> Precond:
    """Complete a coupled `Precond` from the exact off-diagonal Scg [M, 6, G]
    and global Sgg [G, G] blocks: precompute W = D^{-1} Scg and the inverse
    of the global Schur complement Sghat = Sgg - Scg^T D^{-1} Scg (the
    quantities `pcg`'s coupled apply_M consumes).

    ``axis_cam``: mesh axis name when the camera rows (M) are sharded over
    devices (TP mode) — the over-images contraction is psum-ed so the
    replicated Sghat_inv is identical on every shard."""
    if _EXACT_APPLY:
        # elementwise multiply-sum: exact f32 (see _EXACT_APPLY)
        W = (Minv.Minv_c[:, :, :, None] * Scg[:, None, :, :]).sum(axis=2)
        corr = (Scg[:, :, :, None] * W[:, :, None, :]).sum(axis=(0, 1))
    else:
        W = jnp.einsum("mab,mbg->mag", Minv.Minv_c, Scg)
        corr = jnp.einsum("mag,mah->gh", Scg, W)
    if axis_cam is not None:
        corr = jax.lax.psum(corr, axis_cam)
    return Minv._replace(Scg=Scg, W=W,
                         Sghat_inv=jnp.linalg.inv(Sgg - corr))


@_hi_prec
def couple_preconditioner(matvec, Minv: Precond, num_images: int, G: int,
                          dtype=jnp.float32) -> Precond:
    """Upgrade a block `Precond` with the exact camera-global coupling.

    Recovers the Scg [M, 6, G] and Sgg [G, G] blocks of the (damped) reduced
    system with G unit-vector products S @ [0; e_g] — G is tiny (3 + K per
    camera), so this costs G matvecs once per LM step and typically saves
    far more CG iterations.  Works with any matvec implementation."""
    cols_c = []
    cols_g = []
    for g in range(G):
        eg = jnp.zeros(G, dtype).at[g].set(1.0)
        sc, sg = matvec(jnp.zeros((num_images, 6), dtype), eg)
        cols_c.append(sc)
        cols_g.append(sg)
    Scg = jnp.stack(cols_c, axis=2)              # [M, 6, G]
    Sgg = jnp.stack(cols_g, axis=1)              # [G, G] (columns)
    return finish_coupling(Minv, Scg, Sgg)


@_hi_prec
def global_block_preconditioner(p: RCSProblem, b: Blocks):
    """Exact global diagonal block of S, inverted:
    Sgg = Hgg - Hgp Hpp^{-1} Hpg with Hpg accumulated per point."""
    Hgg = jnp.einsum("nia,nib->ab", b.Jg, b.PJg) + jnp.diag(b.extra_g)
    Hpg = _seg_point(p, jnp.einsum("nia,nib->nab", b.Jp, b.PJg))
    Sgg = Hgg - jnp.einsum("pag,pab,pbh->gh", Hpg, b.Hpp_inv, Hpg)
    return jnp.linalg.inv(Sgg)


def make_apply_M(Minv, axis_cam: str | None = None):
    """Preconditioner apply (zc, zg) = M^{-1} (rc, rg) from a `Precond`, a
    bare [M, 6, 6] camera-block array, or an already-callable apply."""
    if callable(Minv):
        return Minv

    def _pc(x):
        return jax.lax.psum(x, axis_cam) if axis_cam is not None else x

    exact = _EXACT_APPLY and isinstance(Minv, Precond)
    if isinstance(Minv, Precond) and Minv.Scg is not None:
        if exact:
            def apply_M(rc_, rg_):
                u = (Minv.Minv_c * rc_[:, None, :]).sum(axis=2)
                zg = Minv.Sghat_inv @ (
                    rg_ - _pc((Minv.Scg * u[:, :, None]).sum(axis=(0, 1))))
                zc = u - (Minv.W * zg[None, None, :]).sum(axis=2)
                return zc, zg
        else:
            def apply_M(rc_, rg_):
                u = jnp.einsum("mab,mb->ma", Minv.Minv_c, rc_)
                zg = Minv.Sghat_inv @ (
                    rg_ - _pc(jnp.einsum("mag,ma->g", Minv.Scg, u)))
                zc = u - jnp.einsum("mag,g->ma", Minv.W, zg)
                return zc, zg
    elif isinstance(Minv, Precond):
        if exact:
            def apply_M(rc_, rg_):
                return ((Minv.Minv_c * rc_[:, None, :]).sum(axis=2),
                        Minv.Minv_g @ rg_)
        else:
            def apply_M(rc_, rg_):
                return (jnp.einsum("mab,mb->ma", Minv.Minv_c, rc_),
                        Minv.Minv_g @ rg_)
    else:
        def apply_M(rc_, rg_):
            return jnp.einsum("mab,mb->ma", Minv, rc_), rg_
    return apply_M


def pcg(p: RCSProblem, b: Blocks, rc, rg, Minv, tol=1e-10, maxiter=200,
        matvec=None, stall_limit=None, axis_cam: str | None = None):
    """Preconditioned CG on the implicit reduced system.

    ``Minv`` is either a `Precond` (camera + global blocks), a bare
    [M, 6, 6] camera-block array (global block treated as identity), or a
    callable apply ``(rc, rg) -> (zc, zg)`` (e.g. the low-rank-corrected
    wrap of parallel/freenet.wrap_precond).
    ``matvec(xc, xg) -> (Sc, Sg)`` overrides the product (e.g. the
    feature-major `engine.schur_matvec`).
    ``stall_limit``: stop once no iteration in a window of this many
    improves the best residual by >=10% — f32 rounding floors the
    achievable residual (floor depends on the preconditioner), and spinning
    at the floor wastes matvecs.  Default: 8 for f32 inputs, disabled for
    f64 (tight-tolerance parity paths legitimately plateau longer).

    ``axis_cam``: mesh axis name when the camera vectors (rc, xc, ...) hold
    only this device's shard of the image rows (TP mode) — the over-images
    contractions (dots, the coupled preconditioner's Scg^T u) are psum-ed
    so the scalar CG recurrences stay replicated-identical."""
    if matvec is None:
        def matvec(xc_, xg_):
            return schur_matvec(p, b, xc_, xg_)

    def _pc(x):
        return jax.lax.psum(x, axis_cam) if axis_cam is not None else x

    apply_M = make_apply_M(Minv, axis_cam=axis_cam)

    def dot(ac, ag, bc_, bg_):
        return _pc(jnp.sum(ac * bc_)) + jnp.sum(ag * bg_)

    xc = jnp.zeros_like(rc)
    xg = jnp.zeros_like(rg)
    zc, zg = apply_M(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    r0norm = jnp.sqrt(dot(rc, rg, rc, rg))
    best0 = r0norm.astype(rc.dtype)
    stall0 = jnp.zeros((), jnp.int32)
    if stall_limit is None:
        stall_limit = 8 if rc.dtype == jnp.float32 else maxiter + 1

    def cond(carry):
        xc, xg, bxc, bxg, rc, rg, pc, pg, rz, best, stall, it = carry
        rnorm = jnp.sqrt(dot(rc, rg, rc, rg))
        return jnp.logical_and(
            jnp.logical_and(it < maxiter, stall < stall_limit),
            rnorm > tol * (1.0 + r0norm))

    def body(carry):
        xc, xg, bxc, bxg, rc, rg, pc, pg, rz, best, stall, it = carry
        qc, qg = matvec(pc, pg)
        alpha = rz / dot(pc, pg, qc, qg)
        xc = xc + alpha * pc
        xg = xg + alpha * pg
        rc = rc - alpha * qc
        rg = rg - alpha * qg
        zc, zg = apply_M(rc, rg)
        rz_new = dot(rc, rg, zc, zg)
        beta = rz_new / rz
        pc = zc + beta * pc
        pg = zg + beta * pg
        rnorm = jnp.sqrt(dot(rc, rg, rc, rg))
        # track the best-residual iterate: long f32 runs can wander (or
        # blow up to NaN) past the rounding floor; returning the best
        # solution keeps the outer (LM / refinement) contraction intact
        is_best = rnorm < best
        bxc = jnp.where(is_best, xc, bxc)
        bxg = jnp.where(is_best, xg, bxg)
        improved = rnorm < 0.9 * best
        best = jnp.where(is_best, rnorm, best)
        stall = jnp.where(improved, 0, stall + 1)
        return xc, xg, bxc, bxg, rc, rg, pc, pg, rz_new, best, stall, it + 1

    xc, xg, bxc, bxg, rc, rg, pc, pg, rz, best, stall, it = \
        jax.lax.while_loop(
            cond, body,
            (xc, xg, xc, xg, rc, rg, pc, pg, rz, best0, stall0,
             jnp.zeros((), jnp.int32)))
    return bxc, bxg, it


@_hi_prec
def back_substitute_points(p: RCSProblem, b: Blocks, xc, xg):
    """dx_p = Hpp^{-1} (bp - Hpx x)."""
    t = jnp.einsum("nia,na->ni", b.PJc, xc[p.obs_image])
    t = t + jnp.einsum("nia,a->ni", b.PJg, xg)
    y = _seg_point(p, jnp.einsum("nia,ni->na", b.Jp, t))
    return jnp.einsum("pab,pb->pa", b.Hpp_inv, b.bp - y)


@_hi_prec
def omega_at(p: RCSProblem, b: Blocks, dxp, dxc, dxg):
    """Omega(dx) = sum (w - J dx)^T P (w - J dx) at the linearisation point
    (getOmega semantics, BundleAdjustment.java:472-491)."""
    Jdx = (jnp.einsum("nia,na->ni", b.Jp, dxp[p.obs_point])
           + jnp.einsum("nia,na->ni", b.Jc, dxc[p.obs_image])
           + jnp.einsum("nia,a->ni", b.Jg, dxg))
    v = b.w - Jdx
    return jnp.sum(v * jnp.einsum("nij,nj->ni", b.P2, v))


@_hi_prec
def prepare(problem: RCSProblem, state: ParamState, spec, damping):
    """Linearise and build everything the PCG needs, with ALL per-image
    reductions fused into one lane-efficient pass:

        [ Hcc diag terms | bc | Hxp Hpp^{-1} bp terms | Scc blocks ]

    concatenated to a single [N, 54] reduction (one wide reduction instead
    of four narrow ones: the reduction machinery runs once).

    Returns (blocks, rc, rg, Precond)."""
    p = problem
    b = linearize(p, state, spec, damping, skip_image_reductions=True)

    z0 = jnp.einsum("pab,pb->pa", b.Hpp_inv, b.bp)
    u0 = jnp.einsum("nia,na->ni", b.PJp, _expand_point(p, z0))

    Pw = jnp.einsum("nij,nj->ni", b.P2, b.w)
    bc_in = jnp.einsum("nia,ni->na", b.Jc, Pw)  # [N, 6]
    JPJ = jnp.einsum("nia,nib->nab", b.Jc, b.PJc)  # [N, 6, 6] (Hcc terms)
    Hpc = jnp.einsum("nia,nib->nab", b.Jp, b.PJc)  # [N, 3, 6]
    corr = jnp.einsum("nab,nac,ncd->nbd", Hpc, _expand_point(p, b.Hpp_inv), Hpc)
    Scc_in = (JPJ - corr).reshape(-1, 36)
    rc_in = jnp.einsum("nia,ni->na", b.Jc, u0)  # [N, 6]
    hcc_diag_in = jnp.einsum("nia,nia->na", b.Jc, b.PJc)  # [N, 6]

    big = jnp.concatenate([bc_in, hcc_diag_in, rc_in, Scc_in], axis=1)
    red = _seg_image(p, big)  # ONE fused image reduction [M, 54]

    bc = red[:, :6]
    extra_c = damping * red[:, 6:12] + (1.0 - p.free_eo)
    if p.de_w is not None:
        we = p.de_w * p.free_eo
        bc = bc + we * (p.de_val - state.eo)
        extra_c = extra_c + we * (1.0 + damping)
    rc = bc - red[:, 12:18]
    Scc = red[:, 18:].reshape(p.num_images, 6, 6)
    Scc = Scc + extra_c[:, :, None] * jnp.eye(6, dtype=Scc.dtype)
    Minv_c = jnp.linalg.inv(Scc)
    b = b._replace(bc=bc, extra_c=extra_c)

    rg = b.bg - jnp.einsum("nia,ni->a", b.Jg, u0)
    Minv = Precond(Minv_c=Minv_c,
                   Minv_g=global_block_preconditioner(p, b))
    return b, rc, rg, Minv


@_hi_prec
def point_ops(p: RCSProblem, b: Blocks):
    """Layout-specific closures for parallel/freenet.py (block layout)."""
    from . import freenet

    def hinv(v):
        return jnp.einsum("pab,pb->pa", b.Hpp_inv, v)

    def hinv_at(idx):
        return b.Hpp_inv[idx]

    def hxp(v):
        u = jnp.einsum("nia,na->ni", b.PJp, _expand_point(p, v))
        oc = _seg_image(p, jnp.einsum("nia,ni->na", b.Jc, u))
        og = jnp.einsum("nia,ni->a", b.Jg, u)
        return oc, og

    def hpx(xc, xg):
        t = jnp.einsum("nia,na->ni", b.PJc, xc[p.obs_image])
        t = t + jnp.einsum("nia,a->ni", b.PJg, xg)
        return _seg_point(p, jnp.einsum("nia,ni->na", b.Jp, t))

    return freenet.PointOps(hinv=hinv, hinv_at=hinv_at, hxp=hxp, hpx=hpx)


@_hi_prec
def omega_at_full(p: RCSProblem, b: Blocks, ext, dxp, dxc, dxg):
    """Omega(dx) including scale-bar and direct-observation rows."""
    from . import freenet

    om = omega_at(p, b, dxp, dxc, dxg)
    if ext is not None:
        om = om + freenet.omega_extras(p, ext, dxp)
    if b.w_dp is not None:
        v = b.w_dp - dxp
        om = om + jnp.sum(p.dp_w * v * v)
    if b.w_de is not None:
        v = b.w_de - dxc
        om = om + jnp.sum(p.de_w * v * v)
    if b.w_dg is not None:
        v = b.w_dg - dxg
        om = om + jnp.sum(p.dg_w * v * v)
    return om


@_hi_prec
def lm_step_full(problem: RCSProblem, state: ParamState, spec, damping,
                 cg_tol=1e-10, cg_maxiter=200, matvec_factory=None):
    """lm_step extended with scale bars and the inner-constraint datum
    (exact low-rank corrections, parallel/freenet.py).

    ``matvec_factory(blocks) -> matvec``: optional base S@x override (a
    different implementation of the product on the same blocks); the
    low-rank corrections wrap it.
    Returns (dxp, dxc, dxg, blocks, cg_it, extras-or-None)."""
    from . import freenet

    b, rc, rg, Minv = prepare(problem, state, spec, damping)
    ext = None
    if problem.has_extras:
        ops = point_ops(problem, b)
        ext = freenet.prepare_extras(problem, state, b.bp, rc, rg, ops,
                                     b.omega0)
        b = b._replace(omega0=ext.omega0)
        rc, rg = ext.rc, ext.rg
    b, ext, rc, rg, Minv = jax.lax.optimization_barrier(
        (b, ext, rc, rg, Minv))
    base = (matvec_factory(b) if matvec_factory is not None
            else lambda c, g: schur_matvec(problem, b, c, g))
    mv = freenet.wrap_matvec(base, ext) if ext is not None else base
    Mi = (freenet.wrap_precond(make_apply_M(Minv), ext)
          if ext is not None else Minv)
    xc, xg, it = pcg(problem, b, rc, rg, Mi, tol=cg_tol,
                     maxiter=cg_maxiter, matvec=mv)
    if ext is not None:
        dxp, _lam = freenet.back_substitute(problem, ext,
                                            point_ops(problem, b), xc, xg)
    else:
        dxp = back_substitute_points(problem, b, xc, xg)
    return dxp, xc, xg, b, it, ext


@_hi_prec
def lm_step(problem: RCSProblem, state: ParamState, spec, damping,
            cg_tol=1e-10, cg_maxiter=200, matvec=None, stall_limit=None):
    """One full LM inner solve: linearise, reduce, PCG, back-substitute.

    ``matvec``: optional override for the S@x product; defaults to the
    block-layout XLA formulation.
    Returns (dxp [P,3], dxc [M,6], dxg [G], blocks, cg_iterations)."""
    b, rc, rg, Minv = prepare(problem, state, spec, damping)
    # Materialise the linearisation before the CG loop: without the barrier
    # XLA fuses block production into the while_loop body and re-computes
    # them every CG iteration (~3x the whole LM step at 100k points).
    b, rc, rg, Minv = jax.lax.optimization_barrier((b, rc, rg, Minv))
    xc, xg, it = pcg(problem, b, rc, rg, Minv, tol=cg_tol, maxiter=cg_maxiter,
                     matvec=matvec, stall_limit=stall_limit)
    dxp = back_substitute_points(problem, b, xc, xg)
    return dxp, xc, xg, b, it


def apply_step(state: ParamState, problem: RCSProblem, dxp, dxc, dxg):
    """x <- x + dx with the global vector split back into (io, dist)."""
    C = state.io.shape[0]
    K = state.dist.shape[1]
    g = dxg.reshape(C, 3 + K)
    return ParamState(
        points=state.points + dxp,
        io=state.io + g[:, :3],
        dist=state.dist + g[:, 3:],
        eo=state.eo + dxc,
    ), jnp.max(jnp.stack([
        jnp.max(jnp.abs(dxp)), jnp.max(jnp.abs(dxc)), jnp.max(jnp.abs(dxg))]))
