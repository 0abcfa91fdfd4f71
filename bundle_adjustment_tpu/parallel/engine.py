"""Feature-major RCS engine: the fast path of the large-scale solver.

Same mathematics as `parallel/rcs.py` (point-eliminated reduced camera
system, implicit-Schur PCG with camera-block + global-block
preconditioning), laid out so that every per-observation quantity is a
**feature row of length N** instead of a [N, 2, k] block tensor: each row
is one contiguous array, and XLA fuses the elementwise row algebra of a
step into few passes over memory.

Reduction strategy (all scatter-free):
  per point : uniform point-major reshape [P, V] -> sum over views
  per image : static permutation to image-sorted order (pad row N), 512-row
              block sums, cumsum-diff over block boundaries
  global    : plain row reductions / one [F, N] @ [N, F] matmul

The reference semantics preserved here are those of rcs.py (survey F1-F9
mapping); tests pin this engine against the block-layout path bit-for-bit
modulo f32 summation order.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.problem import ParamState
from . import rcs

# An f32 matmul without a stated precision may run in TF32 on the GPU (about
# three decimal digits): unacceptable for covariance / normal-equation
# products.  All value x value contractions here pin full f32.
_PREC = jax.lax.Precision.HIGHEST


class FMProblem(NamedTuple):
    """Feature-major problem arrays (static per adjustment)."""

    obs_point: jnp.ndarray   # [N] int32 (point-major, uniform V per point)
    obs_image: jnp.ndarray   # [N] int32
    cam_of_image: jnp.ndarray  # [M] int32
    obs_x: jnp.ndarray       # [N]
    obs_y: jnp.ndarray       # [N]
    wxx: jnp.ndarray         # [N]  2x2 weight rows (sigma0^2 Sigma^{-1})
    wxy: jnp.ndarray         # [N]
    wyy: jnp.ndarray         # [N]
    r0: jnp.ndarray          # [C]
    num_points: int
    num_images: int
    views: int               # uniform views per point
    free_point: jnp.ndarray  # [3, P] rows
    free_eo: jnp.ndarray     # [M, 6]
    free_global: jnp.ndarray  # [G]
    img_perm: jnp.ndarray    # [Nip] int32 (pad entries == N)
    img_block_starts: jnp.ndarray  # [M+1] int32 (block units)
    # directly observed parameters with diagonal weights (cf. rcs.RCSProblem)
    dp_w: jnp.ndarray | None = None    # [P, 3]
    dp_val: jnp.ndarray | None = None  # [P, 3]
    de_w: jnp.ndarray | None = None    # [M, 6]
    de_val: jnp.ndarray | None = None  # [M, 6]
    dg_w: jnp.ndarray | None = None    # [G]
    dg_val: jnp.ndarray | None = None  # [G]


class FMBlocks(NamedTuple):
    """Linearisation in feature rows.  J*/PJ* are tuples of [N] rows.

    Multi-camera COMPACT mode (C > 1): ``Jg``/``PJg`` are None and the
    global rows are carried per LOCAL slot (2*Gp rows, Gp = 3 + K) in
    ``Jg_loc``/``PJg_loc`` plus the per-observation camera id ``cam_obs``
    — O(Gp * N) memory instead of O(C * Gp * N) for the masked global
    rows (VERDICT r4 weak 5).  The masked global row for slot
    g = c*Gp + g' is Jg_loc[g'] * (cam_obs == c) * free_global[g];
    consumers reduce per image and scatter per camera (each image belongs
    to exactly one camera) instead of materialising it."""

    Jp: tuple        # 6 rows: (i, a) for i in (x,y), a in (X,Y,Z)
    PJp: tuple       # 6 rows
    Jc: tuple        # 12 rows: (i, a) over EO
    PJc: tuple       # 12 rows
    Jg: tuple        # 2G rows: (i, g) over IO+distortion (None = compact)
    PJg: tuple       # 2G rows (None = compact)
    w: tuple         # 2 rows (misclosure)
    Pw: tuple        # 2 rows
    Hpp_inv: tuple   # 6 rows [P]: symmetric 3x3 inverse (00,01,02,11,12,22)
    bp: tuple        # 3 rows [P]
    bc: jnp.ndarray  # [M, 6]
    bg: jnp.ndarray  # [G]
    extra_c: jnp.ndarray  # [M, 6]
    extra_g: jnp.ndarray  # [G]
    omega0: jnp.ndarray   # scalar
    # compact multi-camera fields (None in the single-camera layout)
    Jg_loc: tuple = None      # 2*Gp unmasked local-slot rows
    PJg_loc: tuple = None     # 2*Gp rows
    cam_obs: jnp.ndarray = None  # [N] int32


def _G2(p: FMProblem, b: FMBlocks) -> int:
    """Global parameter count G for either layout (static: NamedTuple
    fields are pytree leaves, so G lives in p.free_global's shape, not as
    an int field that optimization_barrier would array-ify)."""
    return p.free_global.shape[0] if b.Jg is None else len(b.Jg) // 2


def fm_problem(p: rcs.RCSProblem) -> FMProblem:
    """Convert an RCSProblem (uniform point-major layout required).

    Every array field goes through jnp.asarray: an RCSProblem may carry
    host numpy arrays (bench.build_problem's transfer discipline), and the
    single device placement happens here."""
    if p.point_uniform is None:
        raise ValueError("engine requires the uniform point-major layout")
    if p.img_perm is None:
        raise ValueError("engine requires the blocked image layout")
    w = p.obs_weight

    def j(a):
        return None if a is None else jnp.asarray(a)

    return FMProblem(
        obs_point=j(p.obs_point), obs_image=j(p.obs_image),
        cam_of_image=j(p.cam_of_image),
        obs_x=jnp.asarray(p.obs_xy[:, 0]),
        obs_y=jnp.asarray(p.obs_xy[:, 1]),
        wxx=jnp.asarray(w[:, 0, 0]),
        wxy=jnp.asarray(w[:, 0, 1]),
        wyy=jnp.asarray(w[:, 1, 1]),
        r0=j(p.r0), num_points=p.num_points, num_images=p.num_images,
        views=p.point_uniform,
        free_point=jnp.asarray(p.free_point).T,
        free_eo=j(p.free_eo), free_global=j(p.free_global),
        img_perm=j(p.img_perm), img_block_starts=j(p.img_block_starts),
        dp_w=j(p.dp_w), dp_val=j(p.dp_val), de_w=j(p.de_w),
        de_val=j(p.de_val), dg_w=j(p.dg_w), dg_val=j(p.dg_val),
    )


def pad_problem(problem: rcs.RCSProblem, state: ParamState,
                multiple: int = 128):
    """Pad the point count to a multiple of ``multiple`` (e.g. the mesh
    size of the point-sharded step) with zero-weight dummy points.

    Dummy points copy point 0's coordinates (finite geometry, so the
    Jacobian rows are finite; their zero weights null every contribution)
    and are marked fixed, so Hpp gets a unit diagonal and dx stays 0.
    Returns (padded RCSProblem, padded ParamState, P_pad).
    """
    P = problem.num_points
    V = problem.point_uniform
    if V is None:
        raise ValueError("pad_problem requires the uniform point-major layout")
    P_pad = -(-P // multiple) * multiple
    if P_pad == P:
        return problem, state, P
    extra = P_pad - P
    n_extra = extra * V
    dt = problem.obs_xy.dtype

    def cat(a, b):
        return jnp.concatenate([a, b])

    obs_point = cat(problem.obs_point,
                    jnp.repeat(P + jnp.arange(extra, dtype=jnp.int32), V))
    obs_image = cat(problem.obs_image, jnp.zeros(n_extra, jnp.int32))
    obs_xy = cat(problem.obs_xy, jnp.zeros((n_extra, 2), dt))
    obs_weight = cat(problem.obs_weight, jnp.zeros((n_extra, 2, 2), dt))
    free_point = cat(problem.free_point, jnp.zeros((extra, 3), dt))

    import numpy as np

    img_perm, img_bs = rcs.build_image_block_layout(
        np.asarray(obs_image), problem.num_images)
    extra_fields = {}
    if problem.dp_w is not None:
        extra_fields["dp_w"] = cat(problem.dp_w, jnp.zeros((extra, 3), dt))
        extra_fields["dp_val"] = cat(problem.dp_val, jnp.zeros((extra, 3), dt))
    if problem.datum_mask_d is not None:
        extra_fields["datum_mask_d"] = cat(problem.datum_mask_d,
                                           jnp.zeros(extra, dt))
    problem = problem._replace(
        obs_point=obs_point, obs_image=obs_image, obs_xy=obs_xy,
        obs_weight=obs_weight, free_point=free_point, num_points=P_pad,
        img_perm=jnp.asarray(img_perm), img_block_starts=jnp.asarray(img_bs),
        point2obs=None, img2obs=None, **extra_fields,
    )
    state = state._replace(points=cat(
        state.points, jnp.broadcast_to(state.points[0], (extra, 3))))
    return problem, state, P


def pad_images(problem: rcs.RCSProblem, state: ParamState, multiple: int):
    """Pad the image count to a multiple of ``multiple`` with fully-fixed
    dummy images (no observation references them, free_eo = 0 gives their
    reduced blocks a unit diagonal, so their step stays exactly 0).  Needed
    by the camera-sharded TP step (spmd_fm cam_shard) when M is not a
    multiple of the mesh size.  Returns (problem, state, M_original)."""
    M = problem.num_images
    Mp = -(-M // multiple) * multiple
    if Mp == M:
        return problem, state, M
    extra = Mp - M
    dt = problem.free_eo.dtype

    def cat0(a, fill=0.0):
        pad = jnp.full((extra,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, pad])

    extra_fields = {}
    if problem.de_w is not None:
        extra_fields["de_w"] = cat0(problem.de_w)
        extra_fields["de_val"] = cat0(problem.de_val)
    bs = problem.img_block_starts
    problem = problem._replace(
        num_images=Mp,
        cam_of_image=cat0(problem.cam_of_image, 0),
        free_eo=cat0(problem.free_eo),
        img_block_starts=jnp.concatenate(
            [bs, jnp.full((extra,), bs[-1], bs.dtype)]),
        img2obs=None,
        **extra_fields,
    )
    state = state._replace(eo=jnp.concatenate(
        [state.eo, jnp.broadcast_to(state.eo[:1], (extra, 6))]))
    return problem, state, M


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _point_sum(p: FMProblem, row):
    """[N] -> [P] over the uniform views."""
    return row.reshape(p.num_points, p.views).sum(axis=1)


def _point_expand(p: FMProblem, col):
    """[P] -> [N] broadcast over views."""
    return jnp.broadcast_to(
        col[:, None], (p.num_points, p.views)).reshape(-1)


def _image_sum_stack(p: FMProblem, rows):
    """Per-image sums of F feature rows: returns [M, F].

    One row-gather into image-sorted order ([Nip, F]) + 512-block sums +
    cumsum-diff; identical numerics to rcs._seg_image.  The gathered
    [Nip, F] copy is transient; reductions over many feature rows at once
    (cov_direct.assemble_reduced_base) reduce chunk-wise instead."""
    x = jnp.stack(rows, axis=1)  # [N, F]
    xp = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])
    xi = xp[p.img_perm]  # [Nip, F]
    nb = xi.shape[0] // rcs.IMG_BLOCK
    bl = xi.reshape(nb, rcs.IMG_BLOCK, -1).sum(axis=1)
    cs = jnp.concatenate([jnp.zeros((1, bl.shape[1]), x.dtype),
                          jnp.cumsum(bl, axis=0)])
    return cs[p.img_block_starts[1:]] - cs[p.img_block_starts[:-1]]


def _sym3_inverse(m00, m01, m02, m11, m12, m22):
    """Closed-form symmetric 3x3 inverse rows (adjugate / det)."""
    i00 = m11 * m22 - m12 * m12
    i01 = m02 * m12 - m01 * m22
    i02 = m01 * m12 - m02 * m11
    i11 = m00 * m22 - m02 * m02
    i12 = m01 * m02 - m00 * m12
    i22 = m00 * m11 - m01 * m01
    det = m00 * i00 + m01 * i01 + m02 * i02
    inv_det = 1.0 / det
    return (i00 * inv_det, i01 * inv_det, i02 * inv_det,
            i11 * inv_det, i12 * inv_det, i22 * inv_det)


def _hinv_apply(H, a0, a1, a2):
    """(6-row symmetric 3x3) @ [3] rows."""
    h00, h01, h02, h11, h12, h22 = H
    return (h00 * a0 + h01 * a1 + h02 * a2,
            h01 * a0 + h11 * a1 + h12 * a2,
            h02 * a0 + h12 * a1 + h22 * a2)


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------

def linearize(p: FMProblem, state: ParamState, spec, damping,
              axis: str | None = None) -> FMBlocks:
    """``axis``: shard_map axis name when the point-major axis is sharded
    across devices — cross-shard (image/global/scalar) reductions are psum-ed;
    per-point quantities stay shard-local."""
    from ..ops import fm

    def _ps(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    P_, V = p.num_points, p.views
    pts = state.points
    X = _point_expand(p, pts[:, 0])
    Y = _point_expand(p, pts[:, 1])
    Z = _point_expand(p, pts[:, 2])

    eo = state.eo
    eog = [eo[:, a][p.obs_image] for a in range(6)]

    C = state.io.shape[0]
    K = state.dist.shape[1]
    G = C * (3 + K)
    if C == 1:
        iog = [jnp.broadcast_to(state.io[0, a], X.shape) for a in range(3)]
        cg = [jnp.broadcast_to(state.dist[0, k], X.shape) for k in range(K)]
        r0 = jnp.broadcast_to(p.r0[0], X.shape)
        cams = None
    else:
        cams = p.cam_of_image[p.obs_image]
        iog = [state.io[:, a][cams] for a in range(3)]
        cg = [state.dist[:, k][cams] for k in range(K)]
        r0 = p.r0[cams]

    rows_x, rows_y, pred_x, pred_y = fm.jacobian_rows(
        X, Y, Z, iog[0], iog[1], iog[2],
        eog[0], eog[1], eog[2], eog[3], eog[4], eog[5], cg, spec, r0)
    w0 = p.obs_x - pred_x
    w1 = p.obs_y - pred_y

    # fixed-parameter masks (column == -2 protocol of the dense layout)
    fp = [_point_expand(p, p.free_point[a]) for a in range(3)]
    fe = [p.free_eo[:, a][p.obs_image] for a in range(6)]

    Jp = tuple(rows_x[a] * fp[a] for a in range(3)) \
        + tuple(rows_y[a] * fp[a] for a in range(3))
    Jc = tuple(rows_x[6 + a] * fe[a] for a in range(6)) \
        + tuple(rows_y[6 + a] * fe[a] for a in range(6))

    # global rows: per camera offset layout [io(3) + dist(K)] * C
    gx = [rows_x[5]] + [rows_x[12 + k] for k in range(K)]
    gy = [rows_y[5]] + [rows_y[12 + k] for k in range(K)]
    # x0 / y0 identity entries occupy global slots 0 / 1
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    gx = [one, zero] + gx
    gy = [zero, one] + gy

    # weight application: PJ = W2x2 J  (correlated x/y,
    # PartialDerivativeFactory.java:313-319)
    def apply_w(rows):
        n = len(rows) // 2
        return tuple(p.wxx * rows[a] + p.wxy * rows[n + a] for a in range(n)) \
            + tuple(p.wxy * rows[a] + p.wyy * rows[n + a] for a in range(n))

    Gp = 3 + K
    if C == 1:
        fg = p.free_global
        Jg = tuple(gx[g] * fg[g] for g in range(G)) \
            + tuple(gy[g] * fg[g] for g in range(G))
        PJg = apply_w(Jg)
        Jg_loc = PJg_loc = None
    else:
        # COMPACT multi-camera layout: keep the 2*Gp unmasked local rows +
        # the per-observation camera id; consumers reduce per image and
        # scatter per camera (FMBlocks docstring) — O(Gp*N) memory
        Jg = PJg = None
        Jg_loc = tuple(gx) + tuple(gy)
        PJg_loc = apply_w(Jg_loc)

    PJp = apply_w(Jp)
    PJc = apply_w(Jc)
    Pw = (p.wxx * w0 + p.wxy * w1, p.wxy * w0 + p.wyy * w1)
    omega0 = jnp.sum(w0 * Pw[0] + w1 * Pw[1])  # shard-local until psum below

    # point blocks
    def hpp(a, b):
        return _point_sum(p, Jp[a] * PJp[b] + Jp[3 + a] * PJp[3 + b])

    m00, m01, m02 = hpp(0, 0), hpp(0, 1), hpp(0, 2)
    m11, m12, m22 = hpp(1, 1), hpp(1, 2), hpp(2, 2)
    fpc = p.free_point
    e0 = damping * m00 + (1.0 - fpc[0])
    e1 = damping * m11 + (1.0 - fpc[1])
    e2 = damping * m22 + (1.0 - fpc[2])
    bp = [_point_sum(p, Jp[a] * Pw[0] + Jp[3 + a] * Pw[1]) for a in range(3)]

    # directly observed point coordinates, diagonal weights (cf. rcs.linearize)
    if p.dp_w is not None:
        w_dp = p.dp_val - pts
        for a in range(3):
            wp = p.dp_w[:, a] * fpc[a]
            bp[a] = bp[a] + wp * w_dp[:, a]
        e0 = e0 + p.dp_w[:, 0] * fpc[0] * (1.0 + damping)
        e1 = e1 + p.dp_w[:, 1] * fpc[1] * (1.0 + damping)
        e2 = e2 + p.dp_w[:, 2] * fpc[2] * (1.0 + damping)
        omega0 = omega0 + jnp.sum(p.dp_w * w_dp * w_dp)
    omega0 = _ps(omega0)  # obs + per-point terms are shard-local
    if p.de_w is not None:
        w_de = p.de_val - state.eo
        omega0 = omega0 + jnp.sum(p.de_w * w_de * w_de)
    Hpp_inv = _sym3_inverse(m00 + e0, m01, m02, m11 + e1, m12, m22 + e2)
    bp = tuple(bp)

    if C == 1:
        G2 = len(Jg) // 2
        Hgg_diag = _ps(jnp.stack(
            [jnp.sum(Jg[g] * PJg[g] + Jg[G2 + g] * PJg[G2 + g])
             for g in range(G2)]))
        bg = _ps(jnp.stack([jnp.sum(Jg[g] * Pw[0] + Jg[G2 + g] * Pw[1])
                            for g in range(G2)]))
    else:
        # per-image sums of the Gp diagonal/rhs rows, scattered per camera
        # (each image belongs to one camera); free applied once (0/1 mask)
        rows_d = [Jg_loc[g] * PJg_loc[g] + Jg_loc[Gp + g] * PJg_loc[Gp + g]
                  for g in range(Gp)]
        rows_b = [Jg_loc[g] * Pw[0] + Jg_loc[Gp + g] * Pw[1]
                  for g in range(Gp)]
        red_g = _ps(_image_sum_stack(p, rows_d + rows_b))   # [M, 2Gp]
        camsum = jnp.zeros((C, 2 * Gp), red_g.dtype).at[
            p.cam_of_image].add(red_g)
        Hgg_diag = camsum[:, :Gp].reshape(-1) * p.free_global
        bg = camsum[:, Gp:].reshape(-1) * p.free_global
    extra_g = damping * Hgg_diag + (1.0 - p.free_global)
    if p.dg_w is not None:
        gvec = jnp.concatenate([state.io, state.dist], axis=1).reshape(-1)
        w_dg = p.dg_val - gvec
        wg = p.dg_w * p.free_global
        extra_g = extra_g + wg * (1.0 + damping)
        bg = bg + wg * w_dg
        omega0 = omega0 + jnp.sum(p.dg_w * w_dg * w_dg)

    return FMBlocks(Jp=Jp, PJp=PJp, Jc=Jc, PJc=PJc, Jg=Jg, PJg=PJg,
                    w=(w0, w1), Pw=Pw, Hpp_inv=Hpp_inv, bp=bp,
                    bc=None, bg=bg, extra_c=None, extra_g=extra_g,
                    omega0=omega0, Jg_loc=Jg_loc, PJg_loc=PJg_loc,
                    cam_obs=cams)


# ---------------------------------------------------------------------------
# reduced system
# ---------------------------------------------------------------------------

def _cam_gather(p: FMProblem, xc):
    """xc [M, 6] -> 6 rows [N]."""
    return [xc[:, a][p.obs_image] for a in range(6)]


def _xg_obs_rows(p: FMProblem, b: FMBlocks, xg):
    """Compact mode: Gp rows [N] of (free * xg) gathered at each
    observation's camera slot — Sum_g PJg[g] xg[g] == Sum_g'
    PJg_loc[g'] * xg_obs[g']."""
    Gp = len(b.Jg_loc) // 2
    xg_eff = (xg * p.free_global).reshape(-1, Gp)
    return [xg_eff[:, g][b.cam_obs] for g in range(Gp)]


def _t_rows(p: FMProblem, b: FMBlocks, xc, xg):
    """t = P (Jc xc + Jg xg) per observation: 2 rows [N]."""
    xcg = _cam_gather(p, xc)
    t = []
    if b.Jg is None:
        Gp = len(b.Jg_loc) // 2
        xs = _xg_obs_rows(p, b, xg)
        for i in (0, 1):
            acc = 0.0
            for a in range(6):
                acc = acc + b.PJc[i * 6 + a] * xcg[a]
            for g in range(Gp):
                acc = acc + b.PJg_loc[i * Gp + g] * xs[g]
            t.append(acc)
        return t
    G2 = len(b.Jg) // 2
    for i in (0, 1):
        acc = 0.0
        for a in range(6):
            acc = acc + b.PJc[i * 6 + a] * xcg[a]
        for g in range(G2):
            acc = acc + b.PJg[i * G2 + g] * xg[g]
        t.append(acc)
    return t


def _point_solve_expand(p: FMProblem, b: FMBlocks, t):
    """z = Hpp^{-1} Jp^T t per point, expanded back to observations."""
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    z = _hinv_apply(b.Hpp_inv, *y)
    return [_point_expand(p, z[a]) for a in range(3)]


def schur_matvec(p: FMProblem, b: FMBlocks, xc, xg, axis: str | None = None,
                 cam_scatter: bool = False):
    """Implicit S @ [xc; xg], feature-major.  ``axis``: psum the cross-shard
    (image/global) reductions when the point axis is sharded.

    ``cam_scatter`` (requires ``axis``): tensor-parallel mode — the reduced
    camera system is *sharded* over the same mesh axis (survey section 2.J's
    TP row).  ``xc`` holds only this shard's M/D image rows (all devices'
    rows concatenated in axis-index order form the full [M, 6]); the full
    vector is re-formed with one tiled all_gather (tiny: 6M floats), and the
    per-image output is combined with one reduce_scatter so each device
    keeps exactly its own rows — all_gather + reduce_scatter take the place
    of the replicated psum."""
    if cam_scatter and axis is None:
        raise ValueError("cam_scatter requires axis (a shard_map axis name)")
    if cam_scatter:
        xc_full = jax.lax.all_gather(xc, axis, axis=0, tiled=True)
    else:
        xc_full = xc
    t = _t_rows(p, b, xc_full, xg)
    zo = _point_solve_expand(p, b, t)
    tv = []
    for i in (0, 1):
        u = sum(b.PJp[i * 3 + a] * zo[a] for a in range(3))
        tv.append(t[i] - u)
    qc = [b.Jc[a] * tv[0] + b.Jc[6 + a] * tv[1] for a in range(6)]
    if b.Jg is None:
        # compact: the Gp local-slot rows share the per-image reduction
        # with qc; camera scatter + free mask turn [M, Gp] into og [G]
        Gp = len(b.Jg_loc) // 2
        qg = [b.Jg_loc[g] * tv[0] + b.Jg_loc[Gp + g] * tv[1]
              for g in range(Gp)]
        stack = _image_sum_stack(p, qc + qg)
        ocm, ogm = stack[:, :6], stack[:, 6:]
        if cam_scatter:
            oc = jax.lax.psum_scatter(ocm, axis, scatter_dimension=0,
                                      tiled=True)
            ogm = jax.lax.psum(ogm, axis)
        elif axis is not None:
            oc = jax.lax.psum(ocm, axis)
            ogm = jax.lax.psum(ogm, axis)
        else:
            oc = ocm
        C = p.free_global.shape[0] // Gp
        og = jnp.zeros((C, Gp), ogm.dtype).at[p.cam_of_image].add(
            ogm).reshape(-1) * p.free_global
        return oc + b.extra_c * xc, og + b.extra_g * xg
    G2 = len(b.Jg) // 2
    og = jnp.stack([jnp.sum(b.Jg[g] * tv[0] + b.Jg[G2 + g] * tv[1])
                    for g in range(G2)])
    oc = _image_sum_stack(p, qc)
    if cam_scatter:
        oc = jax.lax.psum_scatter(oc, axis, scatter_dimension=0, tiled=True)
        og = jax.lax.psum(og, axis)
    elif axis is not None:
        oc = jax.lax.psum(oc, axis)
        og = jax.lax.psum(og, axis)
    return oc + b.extra_c * xc, og + b.extra_g * xg


def prepare(p: FMProblem, state: ParamState, spec, damping,
            couple_global: bool = False,
            axis: str | None = None,
            cam_scatter: bool = False):
    """Linearise + build rhs and the (camera, global) block preconditioner.

    All per-image reductions are fused into one [N, 39 + 6G] pass (cf.
    rcs.prepare); the global Sgg block is assembled with one matmul.
    With ``couple_global`` the exact camera-global off-diagonal blocks
    Scg = Hcg - Hcp Hpp^{-1} Hpg are assembled *directly* inside the same
    fused reduction (6G extra feature rows) instead of recovering them with
    G unit-vector Schur matvecs (rcs.couple_preconditioner) — the per-
    observation form Hpc_n^T Hppinv[pt_n] Hpg[pt_n] is exact for any
    visibility multiplicity because it is linear in Hpc_n.
    Returns (blocks, rc, rg, rcs.Precond)."""
    b = linearize(p, state, spec, damping, axis=axis)
    return reduce_blocks(p, b, state, damping, couple_global=couple_global,
                         axis=axis, cam_scatter=cam_scatter)


def reduce_blocks(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                  couple_global: bool = False, axis: str | None = None,
                  cam_scatter: bool = False):
    """`prepare` minus the linearisation: build rhs + preconditioner from
    an existing FMBlocks."""
    if cam_scatter and axis is None:
        raise ValueError("cam_scatter requires axis (a shard_map axis name)")

    def _ps(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    G2 = _G2(p, b)
    compact = b.Jg is None
    if compact:
        Gp = len(b.Jg_loc) // 2
        C = G2 // Gp
        dt = b.Jp[0].dtype
        sel = [(b.cam_obs == c).astype(dt) for c in range(C)]

    # z0 = Hpp^{-1} bp expanded; u0 = P Jp z0
    z0o = [_point_expand(p, z) for z in _hinv_apply(b.Hpp_inv, *b.bp)]
    u0 = [sum(b.PJp[i * 3 + a] * z0o[a] for a in range(3)) for i in (0, 1)]

    # point cross blocks (needed for Sgg, and for Scg when coupled):
    # Hpg per point [3][G][P] and W = Hpp^{-1} Hpg [G][3][P]
    if compact:
        # masked per-camera point sums of the Gp local products — O(Gp*P)
        # OUTPUT memory (the [N] products are transient), free applied once
        fg = p.free_global
        hpg = [[None] * G2 for _ in range(3)]
        for a in range(3):
            for g in range(Gp):
                q = (b.Jp[a] * b.PJg_loc[g]
                     + b.Jp[3 + a] * b.PJg_loc[Gp + g])
                for c in range(C):
                    hpg[a][c * Gp + g] = _point_sum(p, q * sel[c]) \
                        * fg[c * Gp + g]
    else:
        hpg = [[_point_sum(p, b.Jp[a] * b.PJg[g]
                           + b.Jp[3 + a] * b.PJg[G2 + g])
                for g in range(G2)] for a in range(3)]
    W = [_hinv_apply(b.Hpp_inv, hpg[0][g], hpg[1][g], hpg[2][g])
         for g in range(G2)]  # [G][3][P]

    rows = []
    # bc terms (6)
    rows += [b.Jc[a] * b.Pw[0] + b.Jc[6 + a] * b.Pw[1] for a in range(6)]
    # Hcc diagonal (6)
    rows += [b.Jc[a] * b.PJc[a] + b.Jc[6 + a] * b.PJc[6 + a]
             for a in range(6)]
    # rc correction terms (6)
    rows += [b.Jc[a] * u0[0] + b.Jc[6 + a] * u0[1] for a in range(6)]
    # Scc = Hcc - Hcp Hpp^{-1} Hpc, upper triangle (21)
    # Hpc per obs: hp[a][e] = Jp_a' P Jc_e  (3x6), via PJc
    # per-(point,image) exact correction as in rcs.prepare: each observation
    # contributes Hpc_n^T Hppinv[pt] Hpc_n
    hp = [[b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e] for e in range(6)]
          for a in range(3)]
    hinv_obs = [_point_expand(p, h) for h in b.Hpp_inv]
    H = (hinv_obs[0], hinv_obs[1], hinv_obs[2],
         hinv_obs[3], hinv_obs[4], hinv_obs[5])
    for e in range(6):
        he = _hinv_apply(H, hp[0][e], hp[1][e], hp[2][e])
        for f in range(e, 6):
            jpj = b.Jc[e] * b.PJc[f] + b.Jc[6 + e] * b.PJc[6 + f]
            corr = sum(he[a] * hp[a][f] for a in range(3))
            rows.append(jpj - corr)
    scg_compact = None
    if couple_global:
        if compact:
            # Hcg is camera-LOCAL (Jc[e]*PJg[g] is zero off the image's own
            # camera): 6*Gp local rows in the image stack, expanded to
            # [M, 6, G] in finish_reduction.  The Schur correction
            # Hcp Hpp^{-1} Hpg is NOT local (it couples images to other
            # cameras' slots through shared points) — computed below as a
            # chunked pair-block scatter, O(chunk*V*6*G) transient.
            fg_obs = [sum(sel[c] * p.free_global[c * Gp + g]
                          for c in range(C)) for g in range(Gp)]
            for e in range(6):
                for g in range(Gp):
                    rows.append((b.Jc[e] * b.PJg_loc[g]
                                 + b.Jc[6 + e] * b.PJg_loc[Gp + g])
                                * fg_obs[g])
            scg_compact = _scg_correction(p, b, hp, W, G2)
        else:
            # Scg rows (6G): Hcg - Hcp Hpp^{-1} Hpg, exact per observation
            Wobs = [[_point_expand(p, W[g][a]) for a in range(3)]
                    for g in range(G2)]
            for e in range(6):
                for g in range(G2):
                    hcg = b.Jc[e] * b.PJg[g] + b.Jc[6 + e] * b.PJg[G2 + g]
                    corr = sum(hp[a][e] * Wobs[g][a] for a in range(3))
                    rows.append(hcg - corr)

    stack = _image_sum_stack(p, rows)  # [M, 39 (+ 6G | 6Gp)]
    if cam_scatter:
        # TP mode (survey section 2.J): shard the reduced camera system's
        # rows over the mesh axis — one reduce_scatter lands each device
        # exactly its own M/D image rows instead of a replicated psum, and
        # the per-image preconditioner factorization panels ([M/D, 6, 6]
        # inverses) are built shard-locally.
        red = jax.lax.psum_scatter(stack, axis, scatter_dimension=0,
                                   tiled=True)
    else:
        red = _ps(stack)

    if compact:
        # rg correction: image sums of the Gp local rows -> camera scatter
        rgq = [b.Jg_loc[g] * u0[0] + b.Jg_loc[Gp + g] * u0[1]
               for g in range(Gp)]
        rgm = _ps(_image_sum_stack(p, rgq))                 # [M, Gp]
        rg_corr = jnp.zeros((C, Gp), rgm.dtype).at[
            p.cam_of_image].add(rgm).reshape(-1) * p.free_global
        # T2 block-diagonal per camera: C masked matmuls [2Gp, 2Gp]
        JglM = jnp.stack(b.Jg_loc)
        PJglM = jnp.stack(b.PJg_loc)
        T2 = _ps(jnp.stack([
            jnp.matmul(JglM * sel[c], PJglM.T, precision=_PREC)
            for c in range(C)]))                            # [C, 2Gp, 2Gp]
    else:
        rg_corr = _ps(jnp.stack(
            [jnp.sum(b.Jg[g] * u0[0] + b.Jg[G2 + g] * u0[1])
             for g in range(G2)]))

        # global block pieces: Sgg = Hgg - Hgp Hpp^{-1} Hpg via matmuls
        JgM = jnp.stack(b.Jg)          # [2G, N]
        PJgM = jnp.stack(b.PJg)        # [2G, N]
        T2 = _ps(jnp.matmul(JgM, PJgM.T, precision=_PREC))  # [2G, 2G]
    HpgM = jnp.stack([hpg[a][g] for a in range(3) for g in range(G2)])
    WM = jnp.stack([W[g][a] for a in range(3) for g in range(G2)])
    T3 = _ps(jnp.matmul(WM, HpgM.T, precision=_PREC))  # [(3G), (3G)]
    if scg_compact is not None:
        scg_compact = _ps(scg_compact)
    return finish_reduction(p, b, state, damping, red, rg_corr, T2, T3,
                            couple_global, axis=axis, cam_scatter=cam_scatter,
                            scg_corr=scg_compact)


def finish_reduction(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                     red, rg_corr, T2, T3, couple_global,
                     axis: str | None = None, cam_scatter: bool = False,
                     scg_corr=None):
    """Shared tail of `prepare`: turn the fused per-image reduction ``red``
    [M(, /D), 39 (+ 6G)], the global rhs correction ``rg_corr`` [G], and the
    Sgg matmul pieces ``T2`` [2G, 2G] / ``T3`` [3G, 3G] into
    (blocks, rc, rg, Precond).

    Compact multi-camera mode (b.Jg is None): ``T2`` is the per-camera
    stack [C, 2Gp, 2Gp] (Hgg is block-diagonal), ``red`` carries 6*Gp
    LOCAL Hcg columns, and ``scg_corr`` [M, 6, G] is the non-local Schur
    correction from `_scg_correction`."""
    G2 = _G2(p, b)
    compact = b.Jg is None
    if cam_scatter:
        m_rows = red.shape[0]
        off = jax.lax.axis_index(axis) * m_rows

        def _sl(a):
            return None if a is None else jax.lax.dynamic_slice_in_dim(
                a, off, m_rows)

        free_eo, de_w, de_val = _sl(p.free_eo), _sl(p.de_w), _sl(p.de_val)
        eo_own = _sl(state.eo)
        cam_own = _sl(p.cam_of_image)
        scg_corr = None if scg_corr is None else _sl(scg_corr)
    else:
        m_rows = red.shape[0]
        free_eo, de_w, de_val, eo_own = p.free_eo, p.de_w, p.de_val, state.eo
        cam_own = p.cam_of_image
    bc = red[:, :6]
    extra_c = damping * red[:, 6:12] + (1.0 - free_eo)
    if de_w is not None:
        we = de_w * free_eo
        bc = bc + we * (de_val - eo_own)
        extra_c = extra_c + we * (1.0 + damping)
    rc = bc - red[:, 12:18]
    tri = red[:, 18:39]
    iu = np.triu_indices(6)
    Scc = jnp.zeros((m_rows, 6, 6), red.dtype)
    Scc = Scc.at[:, iu[0], iu[1]].set(tri)
    Scc = Scc.at[:, iu[1], iu[0]].set(tri)
    Scc = Scc + extra_c[:, :, None] * jnp.eye(6, dtype=red.dtype)
    Minv_c = jnp.linalg.inv(Scc)
    b = b._replace(bc=bc, extra_c=extra_c)

    rg = b.bg - rg_corr

    if compact:
        # Hgg is block-diagonal per camera (images own one camera)
        Gp = len(b.Jg_loc) // 2
        C = G2 // Gp
        fg2 = p.free_global.reshape(C, Gp)
        Hblk = (T2[:, :Gp, :Gp] + T2[:, Gp:, Gp:]) \
            * fg2[:, :, None] * fg2[:, None, :]             # [C, Gp, Gp]
        Hgg = jnp.zeros((G2, G2), red.dtype)
        iG = jnp.arange(Gp)
        bi = jnp.arange(C)[:, None, None] * Gp
        Hgg = Hgg.at[bi + iG[None, :, None],
                     bi + iG[None, None, :]].add(Hblk)
        Hgg = Hgg + jnp.diag(b.extra_g)
    else:
        Hgg = T2[:G2, :G2] + T2[G2:, G2:] + jnp.diag(b.extra_g)
    corr_g = sum(T3[a * G2:(a + 1) * G2, a * G2:(a + 1) * G2]
                 for a in range(3))
    Sgg = Hgg - corr_g
    Minv_g = jnp.linalg.inv(Sgg)

    if not couple_global:
        return b, rc, rg, rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g)

    if compact:
        # expand the 6*Gp local Hcg columns to the global width via the
        # image->camera one-hot, then subtract the non-local correction
        hcg_loc = red[:, 39:39 + 6 * Gp].reshape(m_rows, 6, Gp)
        oh = (cam_own[:, None] == jnp.arange(C)[None, :]).astype(red.dtype)
        Scg = jnp.einsum("meg,mc->mecg", hcg_loc, oh).reshape(
            m_rows, 6, G2) - scg_corr
    else:
        Scg = red[:, 39:39 + 6 * G2].reshape(m_rows, 6, G2)
    Minv = rcs.finish_coupling(
        rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g), Scg, Sgg,
        axis_cam=axis if cam_scatter else None)
    return b, rc, rg, Minv


def materialize_global_rows(p: FMProblem, b: FMBlocks) -> FMBlocks:
    """Compact (multi-camera) FMBlocks -> materialized masked global rows
    Jg/PJg — O(C * Gp * N) memory.  Fallback for consumers that index the
    global rows directly (the dense covariance path, parallel/cov_direct);
    the solver hot path never calls this."""
    if b.Jg is not None:
        return b
    Gp = len(b.Jg_loc) // 2
    C = p.free_global.shape[0] // Gp
    dt = b.Jp[0].dtype
    Jg, PJg = [], []
    for i in (0, 1):
        for c in range(C):
            s = (b.cam_obs == c).astype(dt)
            for g in range(Gp):
                f = p.free_global[c * Gp + g]
                Jg.append(b.Jg_loc[i * Gp + g] * s * f)
                PJg.append(b.PJg_loc[i * Gp + g] * s * f)
    return b._replace(Jg=tuple(Jg), PJg=tuple(PJg))


def _div_chunk(P: int, target: int) -> int:
    """Largest chunk <= target dividing P."""
    best = 1
    for c in range(1, min(P, target) + 1):
        if P % c == 0:
            best = c
    return best


def _scg_correction(p: FMProblem, b: FMBlocks, hp, W, G2):
    """Compact-mode Scg Schur correction Hcp Hpp^{-1} Hpg as [M, 6, G2]
    (couples images to ALL cameras' slots through shared points), via a
    chunked pair-block scatter — O(chunk * V * 6 * G2) transient memory."""
    M, V = p.num_images, p.views
    P_ = p.num_points
    dt = b.Jp[0].dtype
    hpc2 = jnp.stack([hp[a][e] for a in range(3) for e in range(6)])
    W2 = jnp.stack([W[g][a] for a in range(3) for g in range(G2)])  # [3G, P]
    img = p.obs_image.astype(jnp.int32)
    chunk = _div_chunk(P_, min(2048, max(64, int(3.0e8 / (V * 6 * G2 * 4)))))
    cV = chunk * V
    i6 = jnp.arange(6, dtype=jnp.int32)

    def _i32(*idx):
        return tuple(jnp.asarray(i, jnp.int32) for i in idx)

    def body(i, acc):
        hpc_v = jax.lax.dynamic_slice(
            hpc2, _i32(0, i * cV), (18, cV)).T.reshape(chunk, V, 3, 6)
        im = jax.lax.dynamic_slice(img, _i32(i * cV), (cV,)).reshape(
            chunk, V)
        wc = jax.lax.dynamic_slice(
            W2, _i32(0, i * chunk), (3 * G2, chunk)).reshape(
            3, G2, chunk).transpose(2, 0, 1)                 # [c, 3, G]
        pg = jnp.einsum("cvae,cag->cveg", hpc_v, wc, precision=_PREC)
        Ig = (6 * im.astype(jnp.int32))[:, :, None] + i6[None, None, :]
        return acc.at[Ig.reshape(-1)].add(pg.reshape(-1, G2))

    acc = jax.lax.fori_loop(0, P_ // chunk, body,
                            jnp.zeros((6 * M, G2), dt))
    return acc.reshape(M, 6, G2)


def back_substitute_points(p: FMProblem, b: FMBlocks, xc, xg):
    """dx_p = Hpp^{-1} (bp - Hpx x): returns [P, 3]."""
    t = _t_rows(p, b, xc, xg)
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    dx = _hinv_apply(b.Hpp_inv, b.bp[0] - y[0], b.bp[1] - y[1],
                     b.bp[2] - y[2])
    return jnp.stack(dx, axis=1)


def omega_at(p: FMProblem, b: FMBlocks, dxp, dxc, dxg):
    """Omega(dx) at the linearisation point (getOmega semantics,
    BundleAdjustment.java:472-491)."""
    dxp_o = [_point_expand(p, dxp[:, a]) for a in range(3)]
    dxc_o = _cam_gather(p, dxc)
    v = []
    if b.Jg is None:
        Gp = len(b.Jg_loc) // 2
        xs = _xg_obs_rows(p, b, dxg)
        for i in (0, 1):
            jdx = sum(b.Jp[i * 3 + a] * dxp_o[a] for a in range(3))
            jdx = jdx + sum(b.Jc[i * 6 + a] * dxc_o[a] for a in range(6))
            jdx = jdx + sum(b.Jg_loc[i * Gp + g] * xs[g] for g in range(Gp))
            v.append(b.w[i] - jdx)
    else:
        G2 = len(b.Jg) // 2
        for i in (0, 1):
            jdx = sum(b.Jp[i * 3 + a] * dxp_o[a] for a in range(3))
            jdx = jdx + sum(b.Jc[i * 6 + a] * dxc_o[a] for a in range(6))
            jdx = jdx + sum(b.Jg[i * G2 + g] * dxg[g] for g in range(G2))
            v.append(b.w[i] - jdx)
    pv0 = p.wxx * v[0] + p.wxy * v[1]
    pv1 = p.wxy * v[0] + p.wyy * v[1]
    return jnp.sum(v[0] * pv0 + v[1] * pv1)


def point_ops(p: FMProblem, b: FMBlocks):
    """Layout-specific closures for parallel/freenet.py (feature-major)."""
    from . import freenet

    def hinv(v):
        return jnp.stack(_hinv_apply(b.Hpp_inv, v[:, 0], v[:, 1], v[:, 2]),
                         axis=1)

    def hinv_at(idx):
        h = [r[idx] for r in b.Hpp_inv]  # 6 sym rows at selected points
        return jnp.stack([
            jnp.stack([h[0], h[1], h[2]], axis=1),
            jnp.stack([h[1], h[3], h[4]], axis=1),
            jnp.stack([h[2], h[4], h[5]], axis=1),
        ], axis=1)  # [k, 3, 3]

    def hxp(v):
        vo = [_point_expand(p, v[:, a]) for a in range(3)]
        u = [sum(b.PJp[i * 3 + a] * vo[a] for a in range(3)) for i in (0, 1)]
        qc = [b.Jc[a] * u[0] + b.Jc[6 + a] * u[1] for a in range(6)]
        if b.Jg is None:
            Gp = len(b.Jg_loc) // 2
            C = p.free_global.shape[0] // Gp
            qg = [b.Jg_loc[g] * u[0] + b.Jg_loc[Gp + g] * u[1]
                  for g in range(Gp)]
            stack = _image_sum_stack(p, qc + qg)
            oc, ogm = stack[:, :6], stack[:, 6:]
            og = jnp.zeros((C, Gp), ogm.dtype).at[p.cam_of_image].add(
                ogm).reshape(-1) * p.free_global
            return oc, og
        oc = _image_sum_stack(p, qc)
        G2 = len(b.Jg) // 2
        og = jnp.stack([jnp.sum(b.Jg[g] * u[0] + b.Jg[G2 + g] * u[1])
                        for g in range(G2)])
        return oc, og

    def hpx(xc, xg):
        t = _t_rows(p, b, xc, xg)
        return jnp.stack(
            [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1])
             for a in range(3)], axis=1)

    return freenet.PointOps(hinv=hinv, hinv_at=hinv_at, hxp=hxp, hpx=hpx)


def omega_at_full(p: FMProblem, rp, b: FMBlocks, ext, dxp, dxc, dxg,
                  state: ParamState):
    """Omega(dx) including scale-bar and direct-observation rows.  ``rp`` is
    the underlying rcs.RCSProblem (carries the scale-bar arrays)."""
    from . import freenet

    om = omega_at(p, b, dxp, dxc, dxg)
    if ext is not None:
        om = om + freenet.omega_extras(rp, ext, dxp)
    if p.dp_w is not None:
        v = (p.dp_val - state.points) - dxp
        om = om + jnp.sum(p.dp_w * v * v)
    if p.de_w is not None:
        v = (p.de_val - state.eo) - dxc
        om = om + jnp.sum(p.de_w * v * v)
    if p.dg_w is not None:
        gvec = jnp.concatenate([state.io, state.dist], axis=1).reshape(-1)
        v = (p.dg_val - gvec) - dxg
        om = om + jnp.sum(p.dg_w * v * v)
    return om


def lm_step_full(p: FMProblem, rp, state: ParamState, spec, damping,
                 cg_tol=1e-10, cg_maxiter=200, couple_global=True):
    """lm_step extended with scale bars and the inner-constraint datum
    (exact low-rank corrections, parallel/freenet.py).  ``rp`` is the
    underlying rcs.RCSProblem carrying sb_*/datum fields.
    Returns (dxp, dxc, dxg, blocks, cg_it, extras-or-None)."""
    from . import freenet

    b, rc, rg, Minv = prepare(p, state, spec, damping,
                              couple_global=couple_global)
    ext = None
    if rp.has_extras:
        ops = point_ops(p, b)
        bp3 = jnp.stack(b.bp, axis=1)
        ext = freenet.prepare_extras(rp, state, bp3, rc, rg, ops, b.omega0)
        b = b._replace(omega0=ext.omega0)
        rc, rg = ext.rc, ext.rg
    b, ext, rc, rg, Minv = jax.lax.optimization_barrier(
        (b, ext, rc, rg, Minv))

    def base(c, g):
        return schur_matvec(p, b, c, g)
    mv = freenet.wrap_matvec(base, ext) if ext is not None else base
    Mi = (freenet.wrap_precond(rcs.make_apply_M(Minv), ext)
          if ext is not None else Minv)
    xc, xg, it = rcs.pcg(None, None, rc, rg, Mi, tol=cg_tol,
                         maxiter=cg_maxiter, matvec=mv)
    if ext is not None:
        dxp, _lam = freenet.back_substitute(rp, ext, point_ops(p, b), xc, xg)
    else:
        dxp = back_substitute_points(p, b, xc, xg)
    return dxp, xc, xg, b, it, ext


def lm_step(p: FMProblem, state: ParamState, spec, damping,
            cg_tol=1e-10, cg_maxiter=200, couple_global=True,
            stall_limit=None):
    """One LM inner solve; returns (dxp, dxc, dxg, blocks, cg_iterations).

    ``couple_global``: upgrade the preconditioner with the exact
    camera-global off-diagonal blocks, assembled directly inside prepare()'s
    fused per-image reduction (large CG iteration savings at the cost of 6G
    extra feature rows in one pass — see prepare).
    ``cg_tol``/``cg_maxiter``/``stall_limit`` may be traced values — one
    compiled program can serve phases with different CG budgets."""
    b, rc, rg, Minv = prepare(p, state, spec, damping,
                              couple_global=couple_global)
    # materialise the linearisation before the CG loop (see rcs.lm_step)
    b, rc, rg, Minv = jax.lax.optimization_barrier((b, rc, rg, Minv))

    def matvec(c, g):
        return schur_matvec(p, b, c, g)
    xc, xg, it = rcs.pcg(None, None, rc, rg, Minv, tol=cg_tol,
                         maxiter=cg_maxiter, matvec=matvec,
                         stall_limit=stall_limit)
    dxp = back_substitute_points(p, b, xc, xg)
    return dxp, xc, xg, b, it
