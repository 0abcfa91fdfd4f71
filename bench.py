"""Benchmark: the BASELINE perf story on the feature-major engine.

Default run (no args) measures BASELINE config 4 (100k pts / 500 img) and
config 5 scale (1M pts / 5k img) on one device:

  (a) time-to-converged from the standard perturbation: f32 LM phase +
      f64 refinement to max|dx| <= 1e-6 absolute (~2e-10 relative —
      beyond the reference's sqrt(eps_f64) criterion); null, with
      ``converged`` false, when refinement misses that;
  (b) steady-state LM it/s at FIXED CG work (8 CG iterations) — a stable
      rate, unlike it/s with state-dependent CG counts;
  (c) Schur-matvec (`engine.schur_matvec`, as XLA compiles it) seconds per
      call, GFLOP/s and bytes/s (the op is bandwidth-bound: ~(21+2G) f32
      rows per observation, `matvec_cost`);
  (d) covariance-blocks rate at scale (direct dense-factored recovery in
      f64 at the refined state, parallel/cov_direct.py — every point's
      3x3 block; a non-finite block fails the run);
  (e) TP distributed-Cholesky GFLOP/s vs single-device XLA Cholesky
      (parallel/tp.py vs MathExtension.java:239-426, the reference's
      hot factorisation kernel).

ONE jitted LM program (dynamic damping / cg_tol / cg_maxiter /
stall_limit, rcs.pcg takes traced loop controls) serves the adaptive phase
AND the fixed-cg8 steady state; the JAX persistent compilation cache is on
(`bundle_adjustment_tpu.compile_cache`).  Every phase runs or the bench
fails; a provisional JSON line is emitted after every phase.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...extras} (consumers read the LAST line; provisional lines precede it).
"device" holds the platform, device_kind and device count as JAX reports
them and each card's name and power limit from nvidia-smi.

Baseline model (vs_baseline): the reference solver as written is dense —
even its most aggressive mode (PRE_ELIMINATION) eliminates the *cameras*
and factorises the remaining [3P + IO + dist] block with packed LAPACK
(BundleAdjustment.java:255-298, MathExtension.java:338-366).  At P = 1e5
that is a 3e5 x 3e5 dense LDL^T: ~(3e5)^3/6 = 4.5e15 flops per iteration
(plus 360 GB for the packed matrix, i.e. it cannot actually run).
Crediting the JVM with a very generous 5e10 flop/s sustained, the Java
reference would do ~1.1e-5 LM iterations/s at this scale; that figure is
the baseline denominator.  (Small-scale parity is covered by
tests/test_golden_example.py; this benchmark measures the scale regime.)
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def build_problem(num_points, num_images, views_per_point, dtype, seed=0,
                  zernike=(), num_cameras=1):
    """Array-native synthetic network (no Python object graph at this scale).

    ``zernike``: optional (DistortionType, fringe_index) tuples added to the
    distortion spec with small non-zero true coefficients (the Zernike
    calibration regime of ExampleDistortionModel.java:58-187).

    ``num_cameras``: C > 1 builds a camera RIG (image m belongs to camera
    m % C, per-camera IO/distortion with small true offsets) — the
    multi-camera model of Camera.java:40-133 at array scale.

    Everything is generated on the HOST (the forward-model pass runs on
    the CPU backend) and the returned RCSProblem holds numpy arrays —
    device placement happens exactly once downstream."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.models.distortion import DistortionSpecBuilder
    from bundle_adjustment_tpu.models.problem import ParamState
    from bundle_adjustment_tpu.ops.residuals import predict_image_point
    from bundle_adjustment_tpu.parallel.rcs import RCSProblem
    from bundle_adjustment_tpu.testing import look_at_wpk

    rng = np.random.default_rng(seed)
    field = 2000.0
    pts = rng.uniform(-field / 2, field / 2, (num_points, 3))
    pts[:, 2] *= 0.2

    C = num_cameras
    io = np.array([[0.02, -0.03, -30.0]]) \
        + 0.01 * np.arange(C)[:, None] * np.array([1.0, -1.0, 30.0])
    builder = DistortionSpecBuilder()
    builder.add_affinity()
    builder.add_tangential()
    builder.add_radial_order(1)
    builder.add_radial_order(2)
    builder.add_radial_order(3)
    for kind, fringe in zernike:
        builder.add_zernike(kind, fringe)
    spec = builder.build()
    K = spec.num_coefficients
    dist = np.zeros((C, K))
    dist[:, spec.slot_index(2, 1)] = -1.1e-4 * (1 + 0.1 * np.arange(C))
    dist[:, spec.slot_index(2, 2)] = 1.5e-7
    for kind, fringe in zernike:
        dist[:, spec.slot_index(kind, fringe)] = 2e-5 * (1 + fringe % 3)

    eo = np.zeros((num_images, 6))
    R = field * 2.0
    for m in range(num_images):
        ang = 2 * np.pi * m / num_images + 0.37 * (m % 5)
        radius = R * (0.7 + 0.12 * (m % 4))
        height = R * (0.5 + 0.2 * (m % 5))
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        eo[m] = [*pos, w, p_, k + (m % 4) * np.pi / 2]

    # visibility: each point sees `views_per_point` random images
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), views_per_point)
    obs_image = rng.integers(0, num_images,
                             num_points * views_per_point).astype(np.int32)

    from bundle_adjustment_tpu.ops.assembly import gather_local_params

    cam_of_image = (np.arange(num_images) % C).astype(np.int32)

    def gen_fn(state):
        local = gather_local_params(state, jnp.asarray(obs_point),
                                    jnp.asarray(obs_image),
                                    jnp.asarray(cam_of_image))
        return jax.vmap(lambda l: predict_image_point(l, spec, 10.0))(local)

    # forward-model generation on the CPU backend: the result stays on the
    # host (a device round-trip is 192 MB at config 5)
    with jax.default_device(jax.devices("cpu")[0]):
        state64 = ParamState(points=jnp.asarray(pts), io=jnp.asarray(io),
                             dist=jnp.asarray(dist), eo=jnp.asarray(eo))
        xy = np.asarray(jax.jit(gen_fn)(state64))
    sigma = 5e-4
    xy = xy + rng.normal(0, sigma, xy.shape)

    w2 = np.zeros((xy.shape[0], 2, 2))
    w2[:, 0, 0] = 1.0  # sigma0^2 / sigma^2 with sigma0 = sigma
    w2[:, 1, 1] = 1.0

    free_point = np.ones((num_points, 3))
    free_point[:3] = 0.0  # fixed-coordinate datum
    free_eo = np.ones((num_images, 6))
    free_global = np.ones(C * (3 + K))

    # perturbed start
    pts0 = pts + rng.normal(0, 0.05, pts.shape) * free_point
    eo0 = eo + rng.normal(0, 1e-5, eo.shape)

    # Blocked image-reduction layout (scatter-free) + uniform point-major
    # reshape reductions — the layout of the feature-major engine.
    from bundle_adjustment_tpu.parallel.rcs import build_image_block_layout

    img_perm, img_bstarts = build_image_block_layout(obs_image, num_images)

    npdt = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    problem = RCSProblem(
        img_perm=img_perm.astype(np.int32),
        img_block_starts=img_bstarts.astype(np.int32),
        point_uniform=views_per_point,
        obs_point=obs_point, obs_image=obs_image,
        cam_of_image=cam_of_image,
        obs_xy=xy.astype(npdt), obs_weight=w2.astype(npdt),
        r0=np.full(C, 10.0, npdt),
        num_points=num_points, num_images=num_images,
        free_point=free_point.astype(npdt),
        free_eo=free_eo.astype(npdt),
        free_global=free_global.astype(npdt),
    )
    state = ParamState(points=jnp.asarray(pts0, dtype),
                       io=jnp.asarray(io, dtype),
                       dist=jnp.asarray(dist, dtype),
                       eo=jnp.asarray(eo0, dtype))
    return problem, state, spec


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def matvec_cost(N, G, V):
    """(flops, bytes) of one implicit Schur matvec in the feature-major
    layout.  ``bytes`` is the least traffic the product needs: the ~21+2G
    f32 rows per observation it reads (Jp, Jc, Jg and the 2x2 weights;
    the P-weighted products are recombined from the weights), read once —
    the op is bandwidth-bound."""
    flops_per_obs = (
        2 * (2 * 6 + 2 * G)      # s rows: Jc xc + Jg xg (+ W2 recombine)
        + 6
        + 3 * 3 + 3              # jt rows + point reduce
        + 15 / V                 # sym3 Hpp^{-1} apply per point
        + 2 * 6 + 2 + 6          # r rows, W2, tv
        + 6 * 3 + 6              # qc rows + image reduce
        + G * 3 + 2 * G          # qg rows + global reduce
    )
    lean_pad = ((21 + 2 * G + 7) // 8) * 8
    fbytes = lean_pad * 4 * N
    return flops_per_obs * N, fbytes


def _time_chain(fn, reps, feed, *args):
    """Seconds per call of ``fn`` over ``reps`` calls after one warm-up,
    each call fed by the previous one's output (``feed(out, args) ->
    args``); the window ends in ``jax.block_until_ready``.  Returns
    (seconds, last output)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        args = feed(out, args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


#: the fused covariance program runs when its rough footprint estimate is
#: under this share of the device's memory limit (the rest holds the
#: solver's live buffers and the estimate's slack); otherwise the staged
#: programs run
FUSED_COV_SHARE = 0.5


def cov_fused(fmp, spec):
    """Every point's 3x3 cofactor block in ONE jitted program: linearise
    (undamped), assemble the dense reduced system, invert it, recover the
    point blocks — in the dtype of the state it is called with.  Returns
    ``covf(state) -> [P, 3, 3]``."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import bigargs, cov_direct, engine

    names, vals = bigargs.split_big(fmp)

    @jax.jit
    def cov(big_, st):
        fp = bigargs.merge(fmp, names, big_)
        bl = engine.linearize(fp, st, spec,
                              jnp.asarray(0.0, st.points.dtype))
        Qred = cov_direct.reduced_inverse(
            cov_direct.assemble_reduced_dense(fp, bl))
        return cov_direct.point_covariance_dense(fp, bl, Qred)

    return lambda st: cov(vals, st)


def cov_staged(fmp, spec):
    """`cov_fused` as staged programs for networks whose fused program
    does not fit the device: each stage relinearises and
    dead-code-eliminates the rows it does not read, and the u x u buffers
    are donated between stages — the camera-camera correction as sparse
    pair blocks (`cov_direct.assemble_reduced_corrections`), the base
    blocks, the Cholesky inverse, and the recovery in multi-dispatch
    groups.  Returns ``covf(state, mark=None) -> [6, P]`` symmetric rows
    (00, 01, 02, 11, 12, 22); ``mark(name, t0, x)`` is called after each
    stage with its output and returns the next stage's start time."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import bigargs, cov_direct, engine

    names, vals = bigargs.split_big(fmp)
    P, G = fmp.num_points, int(fmp.free_global.shape[0])
    chunk = cov_direct.recovery_chunk(P, fmp.views, 6 * fmp.num_images + G)
    nch = P // chunk
    # fixed group size; overflow chunks clamp their ids (sliced off below),
    # so a chunk count with no good divisor still makes few dispatches
    group = min(64, nch)

    def relinearised(fn):
        def run(big_, st):
            fp = bigargs.merge(fmp, names, big_)
            return fn(fp, engine.linearize(
                fp, st, spec, jnp.asarray(0.0, st.points.dtype)))
        return jax.jit(run)

    stage_corr_ = relinearised(cov_direct.assemble_reduced_corrections)
    stage_S0_ = relinearised(cov_direct.assemble_reduced_base)
    stage_qrows_ = relinearised(cov_direct.recovery_rows)
    apply_ = jax.jit(cov_direct.apply_corrections, donate_argnums=0)
    inv_ = jax.jit(cov_direct.reduced_inverse, donate_argnums=0)
    group_ = jax.jit(lambda big_, h2, hi, hg, Qred, i0:
                     cov_direct.point_cov_group(
                         bigargs.merge(fmp, names, big_), h2, hi, hg, Qred,
                         G, i0, chunk, group))

    def sync(name, t, x):
        jax.block_until_ready(x)
        return t

    def covf(st, mark=None):
        # corrections BEFORE the base, and every big reference dropped the
        # moment its consumer has it; block_until_ready BETWEEN stages, so
        # a later stage's buffers are not allocated while earlier outputs
        # are still in flight
        mark = mark or sync
        t = time.time()
        Acc, Acg = stage_corr_(vals, st)
        t = mark("corr", t, Acc)
        S0 = stage_S0_(vals, st)
        t = mark("S0", t, S0)
        S = apply_(S0, Acc, Acg)
        del S0, Acc, Acg
        Qred = inv_(S)
        del S
        t = mark("inv", t, Qred)
        h2, hi, hg = stage_qrows_(vals, st)
        parts = [group_(vals, h2, hi, hg, Qred, jnp.int32(gi * group))
                 for gi in range(-(-nch // group))]
        del h2, hi, hg, Qred
        rows6 = jnp.concatenate(parts, axis=1)[:, :P]
        mark("Q", t, rows6)
        return rows6

    return covf


def nonfinite_blocks(Q) -> int:
    """Number of point blocks with a non-finite entry ([P, 3, 3] blocks or
    [6, P] symmetric rows)."""
    Q = np.asarray(Q)
    Qh = Q.reshape(Q.shape[0], -1) if Q.ndim == 3 else Q.T
    return int(np.sum(~np.isfinite(Qh).all(axis=1)))


def _cov_phase(out, compiles, fmp, state, spec, num_images, G, N, emit):
    """Covariance phase shared by config 4 and config 5, in the dtype of
    ``state``.

    Records WHICH path ran (`cov_path`) and, for the staged path, the
    per-stage first-call seconds (`cov_stage_s`) — emitted progressively
    so a crashed stage is identifiable from the bench record.  A
    non-finite block fails the run."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu import device

    # ---- (d) covariance blocks at scale (direct dense-factored) ---------
    t0 = time.time()
    dtype = state.points.dtype

    # memory-based dispatch: one fused program when the linearisation, S
    # and the inverse's u x u temporaries fit together (no double
    # linearise, single dispatch); otherwise staged programs with buffer
    # donation, capping the peak at (rows + Acc) | (S0 + Acc) | (L + Q) |
    # (rows + Q)
    u_red = 6 * num_images + G
    est_fused = (90 * N + 5 * u_red * u_red + 72 * N) \
        * jnp.dtype(dtype).itemsize                          # bytes, rough
    fused_ok = est_fused < FUSED_COV_SHARE * device.bytes_limit()

    stage_s = {}
    out["cov_path"] = "fused" if fused_ok else "staged"
    out["cov_dtype"] = jnp.dtype(dtype).name
    out["cov_stage_s"] = stage_s

    def _mark(name, t_start, x=None):
        if x is not None:
            jax.block_until_ready(x)
        stage_s[name] = round(time.time() - t_start, 2)
        print(f"cov stage {name}: {stage_s[name]}s", file=sys.stderr)
        if emit is not None:
            emit(dict(out))
        return time.time()

    if fused_ok:
        covf_ = cov_fused(fmp, spec)
        reps = 4
    else:
        covf_ = cov_staged(fmp, spec)
        covf_(state, _mark)
        reps = 1
    if reps > 1:
        Q = covf_(state)
        jax.block_until_ready(Q)
        compiles["cov_compile_s"] = round(time.time() - t0, 2)
        dt_c, Q = _time_chain(
            covf_, reps,
            lambda o, a: (a[0]._replace(
                points=a[0].points + 1e-12 * o[:, :, 0]),),
            state)
    else:
        # staged path: the stage-by-stage first call above compiled every
        # program; ONE warm full pass is the steady rate
        compiles["cov_compile_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        Q = covf_(state._replace(points=state.points + 1e-12))
        jax.block_until_ready(Q)
        dt_c = time.time() - t1
    nblocks = int(Q.shape[0]) if Q.ndim == 3 else int(Q.shape[1])
    out["cov_point_blocks_per_s"] = round(nblocks / dt_c, 1)
    out["cov_all_points_s"] = round(dt_c, 3)
    out["cov_nonfinite_blocks"] = nonfinite_blocks(Q)
    print(f"covariance: ALL {nblocks} point blocks in {dt_c:.3f}s "
          f"({out['cov_point_blocks_per_s']:.0f} blocks/s, direct factored, "
          f"{out['cov_path']}, {out['cov_dtype']})", file=sys.stderr)
    if emit is not None:
        emit(dict(out))
    if out["cov_nonfinite_blocks"]:
        raise RuntimeError(f"covariance: {out['cov_nonfinite_blocks']} of "
                           f"{nblocks} point blocks are not finite")
    return out


def run_suite(num_points, num_images, views, full=True, emit=None):
    """All measurements on one configuration; returns a dict.  ``full``
    adds the TP Cholesky phase (e)."""
    import gc

    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import engine, refine

    dtype = jnp.float32
    out = {}
    compiles = {}
    t0 = time.time()
    print(f"building problem: P={num_points} M={num_images} "
          f"N_obs={num_points * views}", file=sys.stderr)
    problem, state0, spec = build_problem(num_points, num_images, views,
                                          dtype)
    # zero-weight dummy points up to a multiple of 128: cov_direct chunks
    # the point axis by divisors of P
    problem, state0, _ = engine.pad_problem(problem, state0)
    fmp = engine.fm_problem(problem)
    G = 3 + spec.num_coefficients
    N = int(problem.obs_point.shape[0])
    compiles["build_s"] = round(time.time() - t0, 2)
    print(f"build: {compiles['build_s']}s", file=sys.stderr)

    lm_, lm = make_lm(fmp, problem, spec, dtype)

    t0 = time.time()
    r = lm_(state0, jnp.asarray(1e-2, dtype), jnp.asarray(1e-4, dtype),
            jnp.asarray(100, jnp.int32), jnp.asarray(8, jnp.int32),
            jnp.asarray(0.75, dtype))
    jax.block_until_ready(r)
    compiles["lm_compile_s"] = out["first_compile_s"] = \
        round(time.time() - t0, 2)
    print(f"first LM step (incl. compile): {out['first_compile_s']}s",
          file=sys.stderr)
    del r

    # ---- (a) time-to-converged from the standard perturbation ----------
    # f32 LM phase (damping 0.2x schedule) to its floor, then f64
    # refinement to max|dx| <= 1e-6 (absolute; ~2e-10 relative to the
    # km-scale coordinates — beyond the reference's sqrt(eps_f64)).
    refiner = refine.Refiner(problem, spec)
    t0 = time.time()
    jax.block_until_ready(refine_step(refiner, state0, cg_maxiter=1))
    compiles["refine_compile_s"] = out["refine_compile_s"] = \
        round(time.time() - t0, 2)
    print(f"refine compile: {out['refine_compile_s']}s", file=sys.stderr)

    state, mdx, n_f32, t_f32 = f32_phase(lm, state0)
    print(f"f32 phase: {n_f32} its in {t_f32:.2f}s, max|dx|={mdx:.2e}",
          file=sys.stderr)
    s64, n_ref, floor, t_ref = refine_phase(refiner, state)
    print(f"refinement: {n_ref} its in {t_ref:.2f}s, max|dx|={floor:.2e}",
          file=sys.stderr)
    out["converged"] = floor <= 1e-6
    out["time_to_converged_s"] = (round(t_f32 + t_ref, 3)
                                  if out["converged"] else None)
    out["converged_max_dx"] = floor
    out["lm_iterations_to_converge"] = n_f32 + n_ref

    # ---- (b) steady-state LM it/s at fixed CG work (K = 8) -------------
    # Same compiled program: tol=0, maxiter=8, stall disabled.
    def fixed(st):
        return lm_(st, jnp.asarray(1e-6, dtype), jnp.asarray(0.0, dtype),
                   jnp.asarray(8, jnp.int32), jnp.asarray(9, jnp.int32),
                   jnp.asarray(1.0, dtype))

    dt, _ = _time_chain(fixed, 20, lambda o, a: (o[0],), state)
    out["lm_it_per_s_fixed_cg8"] = round(1.0 / dt, 3)
    print(f"steady-state (cg=8 fixed): {1.0 / dt:.3f} it/s",
          file=sys.stderr)
    if emit is not None:  # provisional result in case a later phase is cut
        emit(dict(out))

    # ---- (c) Schur matvec seconds/call, GFLOP/s, bytes/s ----------------
    out.update(matvec_record(fmp, state, spec, G, views))
    print(f"matvec (xla): {out['matvec_xla_ms']} ms/call, "
          f"{out['matvec_xla_gbps']} GB/s", file=sys.stderr)
    out["compile_s"] = compiles
    if emit is not None:
        emit(dict(out))

    # free the solver-phase device state and executables before the
    # covariance phase, which wants the device's memory to itself; the
    # covariance runs in f64 at the refined state
    fmp64 = refiner.fmp64
    del refiner, lm_, lm, fixed, state, state0, fmp
    gc.collect()
    jax.clear_caches()
    gc.collect()
    out = _cov_phase(out, compiles, fmp64, s64, spec, num_images, G, N,
                     emit)
    if full:
        out.update(tp_cholesky_record())
    out["compile_s"] = compiles
    return out


def make_lm(fmp, problem, spec, dtype):
    """ONE jitted LM program for the adaptive phase and the fixed-CG steady
    state: damping / cg_tol / cg_maxiter / stall_limit / alpha are all
    traced (alpha: the damped-step scaling min(0.25 lam^-0.05, 0.75),
    BundleAdjustment.java:392-394, applied to dx before the update).  The
    big problem arrays travel as jit ARGUMENTS (parallel/bigargs.py).

    Returns (lm_(state, lam, cg_tol, cg_maxiter, stall, alpha) on device
    scalars, lm(state, lam, cg_tol=, cg_maxiter=, stall=) on Python
    numbers); both return (state, max|dx|, cg iterations)."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import bigargs, engine, rcs

    big_names, big_vals = bigargs.split_big(fmp)

    def lm_fn(big_, st, lam, cg_tol, cg_maxiter, stall, alpha):
        fp = bigargs.merge(fmp, big_names, big_)
        dxp, dxc, dxg, b, it = engine.lm_step(
            fp, st, spec, lam, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            couple_global=True, stall_limit=stall)
        st2, mdx = rcs.apply_step(st, problem, alpha * dxp, alpha * dxc,
                                  alpha * dxg)
        return st2, mdx, it

    lm0_ = jax.jit(lm_fn)

    def lm_(st, *rest):
        return lm0_(big_vals, st, *rest)

    def lm(st, lam, cg_tol=1e-4, cg_maxiter=100, stall=8):
        alpha = min(0.25 * lam ** -0.05, 0.75) if lam > 0 else 1.0
        return lm_(st, jnp.asarray(lam, dtype),
                   jnp.asarray(cg_tol, dtype),
                   jnp.asarray(cg_maxiter, jnp.int32),
                   jnp.asarray(stall, jnp.int32),
                   jnp.asarray(alpha, dtype))

    return lm_, lm


def refine_step(refiner, state, cg_maxiter=2000):
    """One f64 Gauss-Newton refinement step of (a), undamped like the f64
    reference solve; PCG runs to a 1e-10 residual (`rcs.pcg`'s stop
    rule)."""
    return refiner.step(state, damping=0.0, cg_tol=1e-10,
                        cg_maxiter=cg_maxiter)


def refine_phase(refiner, state, tol=1e-6, max_iterations=8):
    """Refinement of (a) from the f32 phase's ``state`` to max|dx| <= tol
    (absolute; ~2e-10 relative to the km-scale coordinates — beyond the
    reference's sqrt(eps_f64)).  Each f64 step contracts the error by the
    CG solve's accuracy, so 2-4 steps are expected; the budget only bounds
    a run that does not converge.  Returns (f64 state, iterations, last
    max|dx|, seconds)."""
    import jax

    t0 = time.time()
    n = 0
    mdx = float("inf")
    for _ in range(max_iterations):
        state, mdx_r, _om, _it = refine_step(refiner, state)
        n += 1
        mdx = float(mdx_r)
        if mdx <= tol:
            break
    jax.block_until_ready(state)
    return state, n, mdx, time.time() - t0


def f32_phase(lm, state):
    """The f32 LM phase of (a): damping x0.2 per iteration down to 0, until
    max|dx| < 1e-3 or three undamped iterations fail to improve it by 30%%
    (the f32 floor, from where refinement takes over).  Returns (state,
    last max|dx|, iterations, seconds)."""
    damp = 1e-2
    t0 = time.time()
    n = 0
    best, n_flat = float("inf"), 0
    mdx = float("inf")
    for _ in range(60):
        state, mdx, _it = lm(state, damp)
        damp = 0.0 if damp < 1e-9 else damp * 0.2
        n += 1
        mdx = float(mdx)
        if damp == 0.0 and mdx < 1e-3:
            break
        # hand over to f64 refinement once the f32 phase stops
        # improving: its floor is set by f32 conditioning, and refinement
        # contracts from wherever the floor is
        if mdx < 0.7 * best:
            best, n_flat = mdx, 0
        else:
            n_flat += 1
            if damp == 0.0 and n_flat >= 3:
                break
    return state, mdx, n, time.time() - t0


def matvec_record(fmp, state, spec, G, views, reps=5, k1=4, k2=36):
    """(c): the XLA Schur matvec (`engine.schur_matvec`) at the fixed-cg8
    linearisation of ``state`` — seconds per call, GFLOP/s and bytes/s by
    `matvec_cost`.  Run as the CG loop runs it: k products chained in one
    jitted loop, each fed the normalised previous output; timing two chain
    lengths through the same compiled program and differencing cancels
    the per-call dispatch and synchronisation cost.  Every buffer it makes
    dies on return."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import bigargs, engine

    dtype = state.points.dtype
    fn_, fb_ = bigargs.split_big(fmp)
    b, xc, xg, _ = jax.jit(lambda fbig, st: engine.prepare(
        bigargs.merge(fmp, fn_, fbig), st, spec, jnp.asarray(1e-6, dtype),
        couple_global=True))(fb_, state)
    bn_, bb_ = bigargs.split_big(b)

    @jax.jit
    def chain(k, fbig, bbig, c, g):
        fp = bigargs.merge(fmp, fn_, fbig)
        bl = bigargs.merge(b, bn_, bbig)

        def body(_, cg):
            oc, og = engine.schur_matvec(fp, bl, *cg)
            sc = jax.lax.rsqrt(jnp.sum(oc * oc) + jnp.sum(og * og) + 1e-30)
            return oc * sc, og * sc

        return jax.lax.fori_loop(0, k, body, (c, g))

    def run(k):
        k = jnp.asarray(k, jnp.int32)
        jax.block_until_ready(chain(k, fb_, bb_, xc, xg))
        t0 = time.perf_counter()
        for _ in range(reps):
            o = chain(k, fb_, bb_, xc, xg)
        jax.block_until_ready(o)
        return time.perf_counter() - t0

    dt = max(run(k2) - run(k1), 1e-9) / (reps * (k2 - k1))
    flops, fbytes = matvec_cost(int(fmp.obs_x.shape[0]), G, views)
    return {"matvec_xla_ms": round(dt * 1e3, 4),
            "matvec_xla_gflops": round(flops / dt / 1e9, 1),
            "matvec_xla_gbps": round(fbytes / dt / 1e9, 1)}


def tp_cholesky_record(n_fact=4096, block=512):
    """(e): TP distributed Cholesky (1-device mesh) vs XLA's Cholesky.
    KC independent factorisations of scaled copies run inside ONE jitted
    program, every result consumed."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bundle_adjustment_tpu.parallel import tp

    rngf = np.random.default_rng(7)
    A = rngf.normal(0, 1, (n_fact, 256)).astype(np.float32)
    Sspd = jnp.asarray(A @ A.T + n_fact * np.eye(n_fact, dtype=np.float32))
    chol_flops = n_fact ** 3 / 3
    KC = 4
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))

    def batchk(fac):
        def f(S):
            acc = jnp.float32(0)
            for k in range(KC):
                L = fac(S * (1.0 + 1e-6 * (k + 1)))
                acc = acc + L[0, 0] + L[n_fact - 1, n_fact - 1]
            return acc
        return jax.jit(f)

    def seconds(f):
        dt, _ = _time_chain(f, 2, lambda o, a: a, Sspd)
        return dt / KC

    out = {"tp_cholesky_n": n_fact}
    out["xla_cholesky_gflops"] = round(
        chol_flops / seconds(batchk(jnp.linalg.cholesky)) / 1e9, 1)
    out["tp_cholesky_gflops"] = round(chol_flops / seconds(batchk(
        lambda S: tp.cholesky_traced(S, mesh, block=block))) / 1e9, 1)
    print(f"cholesky n={n_fact}: xla {out['xla_cholesky_gflops']} "
          f"GFLOP/s, tp(1dev,block={block}) {out['tp_cholesky_gflops']} "
          f"GFLOP/s", file=sys.stderr)
    return out


def run_mesh_suite(n_mesh, num_points, num_images, views):
    """Sharded perf mode (bench.py --mesh N): fixed-cg LM it/s and the
    effective aggregate matvec bandwidth of the point-sharded feature-major
    step on a mesh of the first ``n_mesh`` devices of the default
    backend."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bundle_adjustment_tpu.parallel import engine, spmd_fm

    devices = jax.devices()
    if len(devices) < n_mesh:
        raise RuntimeError(f"--mesh {n_mesh} needs {n_mesh} devices; the "
                           f"{devices[0].platform} backend has "
                           f"{len(devices)}")
    out = {"mesh_devices": n_mesh, "mesh_platform": devices[0].platform}
    problem, state, spec = build_problem(num_points, num_images, views,
                                         jnp.float32)
    problem, state, _ = engine.pad_problem(problem, state)
    mesh = Mesh(np.array(devices[:n_mesh]), ("pts",))
    problem, state, _ = spmd_fm.pad_for_mesh(problem, state, mesh)
    G = 3 + spec.num_coefficients
    N = int(problem.obs_point.shape[0])

    def feed(o, a):
        (pts, io, dist, eo), mdx, om, it = o
        return (pts, io, dist, eo)

    t0 = time.time()
    res = {}
    for cg in (8, 40):
        step, args0 = spmd_fm.make_spmd_fm_lm_step(
            problem, state, spec, mesh, damping=1e-3,
            cg_tol=1e-30, cg_maxiter=cg, stall_limit=10**6)
        dt, o = _time_chain(step, 6, feed, *args0)
        res[cg] = dt
        assert int(o[3]) == cg, (int(o[3]), cg)
    out["mesh_compile_s"] = round(time.time() - t0, 2)
    out["mesh_lm_it_per_s_fixed_cg8"] = round(1.0 / res[8], 3)
    per_mv = (res[40] - res[8]) / 32.0
    _, fbytes = matvec_cost(N, G, views)
    out["mesh_matvec_ms"] = round(per_mv * 1e3, 3)
    out["mesh_matvec_agg_gbps"] = round(fbytes / per_mv / 1e9, 1)
    print(f"mesh({n_mesh}x{out['mesh_platform']}): "
          f"{out['mesh_lm_it_per_s_fixed_cg8']} it/s cg8, "
          f"matvec {out['mesh_matvec_ms']} ms "
          f"({out['mesh_matvec_agg_gbps']} GB/s aggregate)",
          file=sys.stderr)
    return out


def main():
    import jax

    from bundle_adjustment_tpu import compile_cache, device

    mesh_n = 0
    if "--mesh" in sys.argv:
        i = sys.argv.index("--mesh")
        mesh_n = int(sys.argv[i + 1])
        del sys.argv[i:i + 2]

    # the refinement's gradient pass runs in f64 (explicit dtypes keep the
    # fast path f32)
    jax.config.update("jax_enable_x64", True)
    compile_cache.enable()

    num_points = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000
    num_images = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    views = int(sys.argv[3]) if len(sys.argv) > 3 else 12
    with_config5 = len(sys.argv) <= 1  # default run covers config 4 AND 5
    t_start = time.time()
    dev = device.describe()
    for card in dev["cards"]:
        print(card, file=sys.stderr)

    if mesh_n:
        if len(sys.argv) <= 1:
            num_points, num_images, views = 20_000, 100, 8
        out = run_mesh_suite(mesh_n, num_points, num_images, views)
        result = {
            "metric": f"mesh{mesh_n}_lm_iterations_per_s_{num_points}pts"
                      f"_fixed_cg8",
            "value": out["mesh_lm_it_per_s_fixed_cg8"],
            "unit": "lm_iter/s",
            "vs_baseline": round(
                out["mesh_lm_it_per_s_fixed_cg8"]
                / (1.0 / (((3 * num_points) ** 3 / 6) / 5e10)), 1),
            "device": dev,
            "total_wall_s": round(time.time() - t_start, 1),
        }
        result.update(out)
        print(json.dumps(result), flush=True)
        return

    # baseline: dense Java reference extrapolated to this scale (see module
    # docstring): (3P)^3/6 flops per iteration at a generous 5e10 flop/s.
    java_iter_s = 1.0 / (((3 * num_points) ** 3 / 6) / 5e10)

    def record(partial, label):
        headline = partial.get("lm_it_per_s_fixed_cg8")
        rec = {
            "metric": f"lm_iterations_per_s_{num_points}pts_{num_images}img"
                      f"_fixed_cg8",
            "value": headline,
            "unit": "lm_iter/s",
            "vs_baseline": (round(headline / java_iter_s, 1)
                            if headline is not None else None),
            "phase": label,
            "device": dev,
        }
        rec.update(partial)
        return rec

    # a provisional JSON line after every phase, so a run cut from outside
    # still leaves a parseable record (consumers read the LAST json line)
    def emit(partial, label="provisional"):
        if partial.get("lm_it_per_s_fixed_cg8") is not None:
            print(json.dumps(record(partial, label)), flush=True)

    out = run_suite(num_points, num_images, views, full=True, emit=emit)

    if with_config5:
        emit(dict(out), label="pre_config5")

        def emit5(partial):
            rec = dict(out)
            rec["config5_1m_points"] = partial
            emit(rec, label="config5_partial")

        # BASELINE config 5 scale: 1M points / 5k images on one device
        c5 = run_suite(1_000_000, 5_000, views, full=False, emit=emit5)
        out["config5_1m_points"] = {
            k: c5[k] for k in (
                "lm_it_per_s_fixed_cg8", "converged", "time_to_converged_s",
                "converged_max_dx", "lm_iterations_to_converge",
                "matvec_xla_ms", "matvec_xla_gbps", "cov_path",
                "cov_dtype", "cov_nonfinite_blocks", "cov_point_blocks_per_s",
                "cov_all_points_s",
                "first_compile_s", "compile_s")}

    result = record(out, "complete")
    result["total_wall_s"] = round(time.time() - t_start, 1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
