"""Feature-major engine (parallel/engine.py) parity against the block-layout
RCS path (parallel/rcs.py), in f64 and in the f32 the scale path runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_tpu.models.problem import ParamState
from bundle_adjustment_tpu.parallel import engine, rcs


@pytest.fixture(scope="module")
def small_problem():
    import bench as B

    problem, state, spec = B.build_problem(512, 24, 8, jnp.float64, seed=3)
    return problem, state, spec


def test_linearize_matches_rcs(small_problem):
    problem, state, spec = small_problem
    damping = jnp.asarray(1e-3)
    b_ref = rcs.linearize(problem, state, spec, damping)
    p = engine.fm_problem(problem)
    b = engine.linearize(p, state, spec, damping)

    N = problem.obs_point.shape[0]
    for a in range(3):
        np.testing.assert_allclose(b.Jp[a], b_ref.Jp[:, 0, a], rtol=1e-12)
        np.testing.assert_allclose(b.Jp[3 + a], b_ref.Jp[:, 1, a], rtol=1e-12)
        np.testing.assert_allclose(b.PJp[a], b_ref.PJp[:, 0, a], rtol=1e-12)
    for a in range(6):
        np.testing.assert_allclose(b.Jc[a], b_ref.Jc[:, 0, a], rtol=1e-12)
        np.testing.assert_allclose(b.Jc[6 + a], b_ref.Jc[:, 1, a], rtol=1e-12)
    G = b_ref.Jg.shape[2]
    for g in range(G):
        np.testing.assert_allclose(b.Jg[g], b_ref.Jg[:, 0, g], rtol=1e-12)
        np.testing.assert_allclose(b.Jg[G + g], b_ref.Jg[:, 1, g], rtol=1e-12)
        np.testing.assert_allclose(b.PJg[g], b_ref.PJg[:, 0, g], rtol=1e-12)
    np.testing.assert_allclose(b.w[0], b_ref.w[:, 0], rtol=1e-12)
    np.testing.assert_allclose(b.w[1], b_ref.w[:, 1], rtol=1e-12)
    np.testing.assert_allclose(b.omega0, b_ref.omega0, rtol=1e-10)
    np.testing.assert_allclose(
        jnp.stack(b.bp, axis=1), b_ref.bp, rtol=1e-10, atol=1e-12)
    # Hpp_inv rows vs full inverse
    Hfull = b_ref.Hpp_inv
    np.testing.assert_allclose(b.Hpp_inv[0], Hfull[:, 0, 0], rtol=1e-8)
    np.testing.assert_allclose(b.Hpp_inv[1], Hfull[:, 0, 1],
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(b.Hpp_inv[5], Hfull[:, 2, 2], rtol=1e-8)


def test_prepare_and_matvec_match_rcs(small_problem):
    problem, state, spec = small_problem
    damping = jnp.asarray(1e-3)
    b_ref, rc_ref, rg_ref, M_ref = rcs.prepare(problem, state, spec, damping)
    p = engine.fm_problem(problem)
    b, rc, rg, Minv = engine.prepare(p, state, spec, damping)

    np.testing.assert_allclose(rc, rc_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rg, rg_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.bc, b_ref.bc, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.extra_c, b_ref.extra_c, rtol=1e-9)
    np.testing.assert_allclose(Minv.Minv_c, M_ref.Minv_c, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(Minv.Minv_g, M_ref.Minv_g, rtol=1e-7,
                               atol=1e-10)

    rng = np.random.default_rng(0)
    xc = jnp.asarray(rng.normal(size=rc.shape))
    xg = jnp.asarray(rng.normal(size=rg.shape))
    oc, og = engine.schur_matvec(p, b, xc, xg)
    oc_ref, og_ref = rcs.schur_matvec(problem, b_ref, xc, xg)
    np.testing.assert_allclose(oc, oc_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(og, og_ref, rtol=1e-9, atol=1e-12)


def test_lm_step_matches_rcs(small_problem):
    problem, state, spec = small_problem
    damping = jnp.asarray(1e-4)
    dxp_r, dxc_r, dxg_r, b_r, it_r = rcs.lm_step(
        problem, state, spec, damping, cg_tol=1e-12, cg_maxiter=500)
    p = engine.fm_problem(problem)
    dxp, dxc, dxg, b, it = engine.lm_step(
        p, state, spec, damping, cg_tol=1e-12, cg_maxiter=500)
    np.testing.assert_allclose(dxp, dxp_r, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(dxc, dxc_r, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(dxg, dxg_r, rtol=1e-6, atol=1e-10)
    # omega parity
    om = engine.omega_at(p, b, dxp, dxc, dxg)
    om_r = rcs.omega_at(problem, b_r, dxp_r, dxc_r, dxg_r)
    np.testing.assert_allclose(om, om_r, rtol=1e-8)


def test_coupled_preconditioner(small_problem):
    """The camera-global coupled preconditioner must reach the same solution
    and converge in no more CG iterations than the block one."""
    problem, state, spec = small_problem
    damping = jnp.asarray(1e-4)
    p = engine.fm_problem(problem)
    dxp_b, dxc_b, dxg_b, _, it_b = engine.lm_step(
        p, state, spec, damping, cg_tol=1e-10, cg_maxiter=500,
        couple_global=False)
    dxp_c, dxc_c, dxg_c, _, it_c = engine.lm_step(
        p, state, spec, damping, cg_tol=1e-10, cg_maxiter=500,
        couple_global=True)
    np.testing.assert_allclose(dxp_c, dxp_b, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(dxc_c, dxc_b, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(dxg_c, dxg_b, rtol=1e-5, atol=1e-8)
    assert int(it_c) <= int(it_b)


def test_direct_scg_matches_matvec_recovery(small_problem):
    """prepare(couple_global=True) assembles Scg/Sghat_inv directly in the
    fused reduction; it must match the blocks recovered with G unit-vector
    Schur matvecs (rcs.couple_preconditioner)."""
    problem, state, spec = small_problem
    damping = jnp.asarray(1e-4)
    p = engine.fm_problem(problem)
    b, rc, rg, Minv = engine.prepare(p, state, spec, damping,
                                     couple_global=True)
    base = rcs.Precond(Minv_c=Minv.Minv_c, Minv_g=Minv.Minv_g)
    ref = rcs.couple_preconditioner(
        lambda c, g: engine.schur_matvec(p, b, c, g), base,
        p.num_images, rg.shape[0], rg.dtype)
    np.testing.assert_allclose(Minv.Scg, ref.Scg, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(Minv.W, ref.W, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(Minv.Sghat_inv, ref.Sghat_inv,
                               rtol=1e-7, atol=1e-10)


def test_pad_problem_parity(small_problem):
    """Padding to a 128-multiple must not change the solution and must keep
    dummy-point steps exactly zero."""
    import bench as B

    problem, state, spec = B.build_problem(500, 24, 8, jnp.float64, seed=3)
    problem2, state2, P = engine.pad_problem(problem, state)
    assert problem2.num_points == 512 and P == 500
    fmp = engine.fm_problem(problem2)
    damping = jnp.asarray(1e-4)
    dxp, dxc, dxg, b, it = engine.lm_step(
        fmp, state2, spec, damping, cg_tol=1e-12, cg_maxiter=500)
    dxp_r, dxc_r, dxg_r, *_ = rcs.lm_step(
        problem, state, spec, damping, cg_tol=1e-12, cg_maxiter=500)
    np.testing.assert_allclose(dxp[:500], dxp_r, rtol=1e-6, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(dxp[500:]), 0.0)
    np.testing.assert_allclose(dxc, dxc_r, rtol=1e-6, atol=1e-10)


@pytest.fixture(scope="module")
def zernike_problem():
    """Zernike-Gradient calibration regime (ExampleDistortionModel.java:72-87)
    on the synthetic network: radial + tangential + affinity + Zernike
    gradient fringes 4 and 12 and a Zernike-X fringe 5."""
    import bench as B
    from bundle_adjustment_tpu.models.distortion import DistortionType as DT

    problem, state, spec = B.build_problem(
        256, 16, 8, jnp.float64, seed=7,
        zernike=((DT.ZERNIKE_GRADIENT, 4), (DT.ZERNIKE_GRADIENT, 12),
                 (DT.ZERNIKE_X, 5)))
    return problem, state, spec


def test_zernike_fm_linearize_matches_rcs(zernike_problem):
    """Feature-major Zernike rows vs the scalar analytic path (itself pinned
    to jacfwd of the forward deltas in test_analytic_jacobian)."""
    problem, state, spec = zernike_problem
    damping = jnp.asarray(1e-3)
    b_ref = rcs.linearize(problem, state, spec, damping)
    p = engine.fm_problem(problem)
    b = engine.linearize(p, state, spec, damping)
    G = b_ref.Jg.shape[2]
    assert G == 3 + spec.num_coefficients
    for g in range(G):
        np.testing.assert_allclose(b.Jg[g], b_ref.Jg[:, 0, g],
                                   rtol=1e-11, atol=1e-14)
        np.testing.assert_allclose(b.Jg[G + g], b_ref.Jg[:, 1, g],
                                   rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(b.w[0], b_ref.w[:, 0], rtol=1e-12)
    np.testing.assert_allclose(b.w[1], b_ref.w[:, 1], rtol=1e-12)


def test_zernike_lm_step_matches_rcs(zernike_problem):
    problem, state, spec = zernike_problem
    damping = jnp.asarray(1e-4)
    dxp_r, dxc_r, dxg_r, b_r, _ = rcs.lm_step(
        problem, state, spec, damping, cg_tol=1e-12, cg_maxiter=800)
    p = engine.fm_problem(problem)
    dxp, dxc, dxg, b, _ = engine.lm_step(
        p, state, spec, damping, cg_tol=1e-12, cg_maxiter=800)
    np.testing.assert_allclose(dxp, dxp_r, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dxc, dxc_r, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(dxg, dxg_r, rtol=1e-5, atol=1e-9)
    om = engine.omega_at(p, b, dxp, dxc, dxg)
    om_r = rcs.omega_at(problem, b_r, dxp_r, dxc_r, dxg_r)
    np.testing.assert_allclose(om, om_r, rtol=1e-8)


def test_zernike_solver_convergence():
    """End-to-end Zernike-Gradient calibration at scale: mirrors
    ExampleDistortionModel.java:72-87 — the principal distance c and the
    polynomial radial model are held fixed (the m = 0 Zernike gradients span
    exactly the radial-polynomial + scale basis, so leaving both free is a
    rank defect by construction).  The LM driver must converge with Omega at
    the noise level."""
    import bench as B
    from bundle_adjustment_tpu.models.distortion import DistortionType as DT
    from bundle_adjustment_tpu.parallel import solver

    problem, state, spec = B.build_problem(
        256, 16, 8, jnp.float64, seed=7,
        zernike=((DT.ZERNIKE_GRADIENT, 12), (DT.ZERNIKE_GRADIENT, 24),
                 (DT.ZERNIKE_X, 5)))
    fg = np.asarray(problem.free_global).copy()
    fg[2] = 0.0  # c
    for o in (1, 2, 3):
        fg[3 + spec.slot_index(DT.RADIAL_DISTORTION, o)] = 0.0
    problem = problem._replace(free_global=jnp.asarray(fg))

    res = solver.solve(problem, state, spec, damping=1e-2,
                       max_iterations=20, cg_tol=1e-11, cg_maxiter=1000)
    assert res.converged
    assert res.max_abs_dx < 1e-8
    # Omega ~ dof * sigma^2 with sigma = 5e-4 and unit weights (sigma0 = sigma)
    n_rows = 2 * problem.obs_point.shape[0]
    u = int(np.sum(np.asarray(problem.free_point))
            + np.sum(np.asarray(problem.free_eo)) + np.sum(fg))
    expected = (n_rows - u) * (5e-4) ** 2
    assert abs(res.omega / expected - 1.0) < 0.2


# ---------------------------------------------------------------------------
# the f32 scale path (what bench.py and the refiner run) against f64
# ---------------------------------------------------------------------------

def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if getattr(x, "dtype", None) == jnp.float64 else x,
                        tree)


def _close_scaled(a, b, tol):
    """max|a - b| relative to max|b| (per-element rtol is meaningless below
    f32 eps * |S| for entries of mixed magnitude)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    assert err < tol, f"scaled error {err:.3e} > {tol}"


@pytest.mark.parametrize("shape", [(128, 10, 4), (512, 24, 8),
                                   (256, 130, 8), "zernike"],
                         ids=["small", "512-24-8", "256-130-8", "zernike"])
def test_f32_schur_matvec_matches_f64_block_layout(shape):
    """f32 engine.schur_matvec (the XLA product the PCG loop runs) on the
    f32 blocks vs the f64 block-layout matvec of rcs.py: one image block
    (small), many views, M > 128 images, and Zernike global rows."""
    import bench as B
    from bundle_adjustment_tpu.models.distortion import DistortionType as DT

    if shape == "zernike":
        problem, state, spec = B.build_problem(
            256, 16, 8, jnp.float64, seed=7,
            zernike=((DT.ZERNIKE_GRADIENT, 4), (DT.ZERNIKE_GRADIENT, 12),
                     (DT.ZERNIKE_X, 5)))
    else:
        problem, state, spec = B.build_problem(*shape, jnp.float64, seed=5)
    damping = jnp.asarray(1e-3)
    b_ref = rcs.prepare(problem, state, spec, damping)[0]
    p = engine.fm_problem(problem)
    b = engine.prepare(p, state, spec, damping)[0]

    rng = np.random.default_rng(1)
    xc = rng.normal(size=(problem.num_images, 6))
    xg = rng.normal(size=(3 + spec.num_coefficients,))
    oc, og = engine.schur_matvec(_f32(p), _f32(b),
                                 jnp.asarray(xc, jnp.float32),
                                 jnp.asarray(xg, jnp.float32))
    assert oc.dtype == jnp.float32 and og.dtype == jnp.float32
    oc_ref, og_ref = rcs.schur_matvec(problem, b_ref, jnp.asarray(xc),
                                      jnp.asarray(xg))
    _close_scaled(oc, oc_ref, 2e-4)
    _close_scaled(og, og_ref, 2e-4)


@pytest.mark.parametrize("couple_global", [True, False],
                         ids=["coupled", "uncoupled"])
def test_f32_prepare_matches_f64(couple_global):
    """f32 engine.prepare (linearise + fused per-image reduction +
    preconditioner) vs the same assembly in f64 on the same data."""
    import bench as B

    problem, state, spec = B.build_problem(256, 12, 6, jnp.float64, seed=11)
    p32, s32 = _f32(engine.fm_problem(problem)), _f32(state)

    def up(tree):
        return jax.tree.map(lambda x: x.astype(jnp.float64)
                            if getattr(x, "dtype", None) == jnp.float32
                            else x, tree)

    b64, rc64, rg64, M64 = engine.prepare(up(p32), up(s32), spec,
                                          jnp.asarray(1e-3),
                                          couple_global=couple_global)
    b, rc, rg, Minv = engine.prepare(p32, s32, spec,
                                     jnp.asarray(1e-3, jnp.float32),
                                     couple_global=couple_global)
    assert rc.dtype == jnp.float32
    # the gradient is a cancelling sum over f32 residuals (~1e-3 relative:
    # what the f64 refiner exists for); the Hessian side of the
    # assembly does not cancel and holds f32 accuracy
    _close_scaled(rc, rc64, 1e-2)
    _close_scaled(rg, rg64, 1e-2)
    _close_scaled(b.bc, b64.bc, 1e-2)
    _close_scaled(b.omega0, b64.omega0, 2e-3)
    _close_scaled(b.extra_c, b64.extra_c, 1e-5)
    _close_scaled(Minv.Minv_c, M64.Minv_c, 5e-4)
    if couple_global:
        _close_scaled(Minv.Sghat_inv, M64.Sghat_inv, 5e-4)
        _close_scaled(Minv.Scg, M64.Scg, 1e-5)
    else:
        assert Minv.Scg is None
        _close_scaled(Minv.Minv_g, M64.Minv_g, 5e-4)


def test_f32_lm_steps_reach_f64_solution():
    """The f32 engine.lm_step loop (bench's f32 phase) reaches the f64
    optimum of the block-layout solver to its f32 floor.  Measured by
    Omega, evaluated in f64: the points of a small network have weakly
    determined directions along which the f32 floor wanders far (the
    refiner then recovers them, tests/test_refine.py)."""
    import bench as B
    from bundle_adjustment_tpu.parallel import solver

    problem, state, spec = B.build_problem(256, 16, 8, jnp.float64, seed=2)
    ref = solver.solve(problem, state, spec, damping=0.0, max_iterations=20,
                       cg_tol=1e-12, cg_maxiter=1000)
    assert ref.converged

    def omega(st):
        st = jax.tree.map(lambda x: x.astype(jnp.float64), st)
        return float(rcs.linearize(problem, st, spec,
                                   jnp.asarray(0.0)).omega0)

    p32 = _f32(problem)
    fmp = engine.fm_problem(p32)
    _, lm = B.make_lm(fmp, p32, spec, jnp.float32)
    st, mdx, n, _ = B.f32_phase(lm, _f32(state))
    assert st.points.dtype == jnp.float32 and n >= 2
    om_ref = omega(ref.state)
    assert omega(state) / om_ref - 1.0 > 0.5     # the start is far off
    assert abs(omega(st) / om_ref - 1.0) < 2e-3
