"""Direct (dense factored) covariance vs the explicit reduced system and the
matrix-free PCG recovery (cross-mode equality, survey hard-part 5)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "/root/repo")


@pytest.fixture(scope="module")
def small_problem():
    import bench as B
    from bundle_adjustment_tpu.parallel import engine, rcs

    problem, state, spec = B.build_problem(192, 7, 4, jnp.float64, seed=3)
    problem, state, _ = engine.pad_problem(problem, state, multiple=64)
    fmp = engine.fm_problem(problem)
    b_fm = engine.linearize(fmp, state, spec, jnp.float64(0.0))
    b_rcs = rcs.linearize(problem, state, spec, jnp.float64(0.0))
    return problem, fmp, state, spec, b_fm, b_rcs


def test_dense_assembly_matches_tp(small_problem):
    """cov_direct.assemble_reduced_dense (chunked matmul panels) ==
    tp.assemble_reduced_system (pair-tensor formulation) element-wise."""
    from bundle_adjustment_tpu.parallel import cov_direct, tp

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S1 = np.asarray(cov_direct.assemble_reduced_dense(fmp, b_fm, chunk=64))
    S2, _ = tp.assemble_reduced_system(problem, b_rcs)
    S2 = np.asarray(S2)
    assert S1.shape == S2.shape
    scale = np.abs(S2).max()
    np.testing.assert_allclose(S1, S2, rtol=1e-9, atol=1e-9 * scale)


def test_panel_and_sparse_corrections_agree(small_problem):
    """The two corrections formulations (dense matmul panels vs sparse pair
    blocks) produce the same (Acc, Acg) and the same assembled S for both
    dispatch settings."""
    from bundle_adjustment_tpu.parallel import cov_direct

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    Acc_p, Acg_p = cov_direct.assemble_corrections_panel(fmp, b_fm, chunk=64)
    Acc_s, Acg_s = cov_direct.assemble_reduced_corrections(fmp, b_fm,
                                                           chunk=64)
    scale = np.abs(np.asarray(Acc_s)).max()
    np.testing.assert_allclose(np.asarray(Acc_p), np.asarray(Acc_s),
                               rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(Acg_p), np.asarray(Acg_s),
                               rtol=1e-9, atol=1e-9 * scale)
    S_p = np.asarray(cov_direct.assemble_reduced_dense(fmp, b_fm, panel=True))
    S_s = np.asarray(cov_direct.assemble_reduced_dense(fmp, b_fm,
                                                       panel=False))
    np.testing.assert_allclose(S_p, S_s, rtol=1e-9,
                               atol=1e-9 * np.abs(S_s).max())


def test_point_blocks_match_pcg(small_problem):
    """Dense-factored point blocks == matrix-free PCG recovery (f64)."""
    from bundle_adjustment_tpu.parallel import cov_direct, covariance

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S = cov_direct.assemble_reduced_dense(fmp, b_fm)
    Qred = cov_direct.reduced_inverse(S)

    ids = np.array([5, 50, 101, 190], np.int32)
    Qd = np.asarray(cov_direct.point_covariance_dense(
        fmp, b_fm, Qred, jnp.asarray(ids)))
    Qp = np.asarray(covariance.point_covariance_blocks(
        problem, b_rcs, jnp.asarray(ids), tol=1e-13, maxiter=4000))
    np.testing.assert_allclose(Qd, Qp, rtol=1e-7, atol=1e-13)


def test_all_points_and_remainder_chunking(small_problem):
    """point_ids=None computes every point; explicit non-dividing chunk
    exercises the remainder path; both agree with the selected-id path."""
    from bundle_adjustment_tpu.parallel import cov_direct

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S = cov_direct.assemble_reduced_dense(fmp, b_fm)
    Qred = cov_direct.reduced_inverse(S)
    Qall = np.asarray(cov_direct.point_covariance_dense(fmp, b_fm, Qred))
    assert Qall.shape == (fmp.num_points, 3, 3)
    ids = np.arange(0, fmp.num_points, 7, dtype=np.int32)
    Qsel = np.asarray(cov_direct.point_covariance_dense(
        fmp, b_fm, Qred, jnp.asarray(ids), chunk=5))
    # selected ids run the row-gather path, all-points the dense-panel
    # path — different f64 summation orders, so tolerance is
    # reassociation-level, not bit-match
    np.testing.assert_allclose(Qsel, Qall[ids], rtol=1e-9, atol=1e-13)


def test_camera_and_pair_blocks(small_problem):
    """Camera 6x6 blocks == S^{-1} sub-blocks; cross-point pair blocks ==
    PCG pair recovery."""
    from bundle_adjustment_tpu.parallel import cov_direct, covariance

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S = cov_direct.assemble_reduced_dense(fmp, b_fm)
    Qred = cov_direct.reduced_inverse(S)

    cam_ids = np.array([0, 3], np.int32)
    Qc = np.asarray(cov_direct.camera_covariance_dense(Qred, cam_ids))
    for j, m in enumerate(cam_ids):
        np.testing.assert_allclose(
            Qc[j], np.asarray(Qred)[6 * m:6 * m + 6, 6 * m:6 * m + 6],
            rtol=1e-12)

    pairs = np.array([[5, 50], [101, 190]], np.int32)
    Qd = np.asarray(cov_direct.point_pair_covariance_dense(
        fmp, b_fm, Qred, pairs))
    Qp = np.asarray(covariance.point_pair_covariance_blocks(
        problem, b_rcs, pairs, tol=1e-13, maxiter=4000))
    np.testing.assert_allclose(Qd, Qp, rtol=1e-6, atol=1e-13)


def test_panel_streamed_inverse(small_problem):
    """reduced_inverse panel streaming (incl. a non-dividing panel that
    forces the identity-padded tail) == one-shot inverse."""
    from bundle_adjustment_tpu.parallel import cov_direct

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S = cov_direct.assemble_reduced_dense(fmp, b_fm)
    Q0 = np.asarray(cov_direct.reduced_inverse(S))
    u = S.shape[0]
    for panel in (16, 7):  # 7 does not divide u -> padded tail path
        Qp = np.asarray(cov_direct.reduced_inverse(S, panel=panel))
        np.testing.assert_allclose(Qp, Q0, rtol=5e-9,
                                   atol=5e-9 * np.abs(Q0).max())
    assert Q0.shape == (u, u)


def test_blocked_reduced_inverse_matches_oneshot():
    """The blocked-substitution panel inverse (the u=30k memory path) ==
    the one-shot triangular-solve inverse on a small SPD matrix, including
    a non-dividing u (identity-tail padding)."""
    from bundle_adjustment_tpu.parallel import cov_direct

    rng = np.random.default_rng(9)
    u = 300  # not a multiple of block
    A = rng.normal(0, 1, (u, 24))
    S = jnp.asarray(A @ A.T + u * np.eye(u))
    Q0 = np.asarray(cov_direct.reduced_inverse(S))
    Q1 = np.asarray(cov_direct.reduced_inverse(S, panel=64, block=64))
    np.testing.assert_allclose(Q1, Q0, rtol=1e-9, atol=1e-12)


def test_panel_onehot_fill_f32():
    """The f32 one-hot matmul panel fill (the large-M branch, in place of a
    [c, 3, M, 6] scatter destination) agrees with the sparse pair-block
    form to the split-bf16 accuracy (~2^-16 relative)."""
    import bench as B
    from bundle_adjustment_tpu.parallel import cov_direct, engine

    problem, state, spec = B.build_problem(192, 9, 4, jnp.float32, seed=3)
    problem, state, _ = engine.pad_problem(problem, state, multiple=64)
    fmp = engine.fm_problem(problem)
    b = engine.linearize(fmp, state, spec, jnp.float32(0.0))
    Acc_p, Acg_p = cov_direct.assemble_corrections_panel(fmp, b, chunk=64)
    Acc_s, Acg_s = cov_direct.assemble_reduced_corrections(fmp, b, chunk=64)
    scale = np.abs(np.asarray(Acc_s)).max()
    np.testing.assert_allclose(np.asarray(Acc_p), np.asarray(Acc_s),
                               rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(Acg_p), np.asarray(Acg_s),
                               rtol=1e-4, atol=1e-5 * scale)


def test_outer_corrections_agree(small_problem):
    """The outer-product e-major corrections (the small-K fused fast path)
    == the sparse pair-block form, f64 exact and f32 to split-bf16
    accuracy."""
    import bench as B
    from bundle_adjustment_tpu.parallel import cov_direct, engine

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    Acc_o, Acg_o = cov_direct.assemble_corrections_outer(fmp, b_fm,
                                                         chunk=64)
    Acc_s, Acg_s = cov_direct.assemble_reduced_corrections(fmp, b_fm,
                                                           chunk=64)
    scale = np.abs(np.asarray(Acc_s)).max()
    np.testing.assert_allclose(np.asarray(Acc_o), np.asarray(Acc_s),
                               rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(Acg_o), np.asarray(Acg_s),
                               rtol=1e-9, atol=1e-9 * scale)

    prob32, st32, spec32 = B.build_problem(192, 9, 4, jnp.float32, seed=3)
    prob32, st32, _ = engine.pad_problem(prob32, st32, multiple=64)
    fm32 = engine.fm_problem(prob32)
    b32 = engine.linearize(fm32, st32, spec32, jnp.float32(0.0))
    Acc_o, Acg_o = cov_direct.assemble_corrections_outer(fm32, b32,
                                                         chunk=64)
    Acc_s, Acg_s = cov_direct.assemble_reduced_corrections(fm32, b32,
                                                           chunk=64)
    scale = np.abs(np.asarray(Acc_s)).max()
    np.testing.assert_allclose(np.asarray(Acc_o), np.asarray(Acc_s),
                               rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(Acg_o), np.asarray(Acg_s),
                               rtol=1e-4, atol=1e-5 * scale)


def test_point_cov_group_matches_dense(small_problem):
    """Multi-dispatch rows recovery (point_cov_group) == the one-shot
    dense recovery."""
    from bundle_adjustment_tpu.parallel import cov_direct

    problem, fmp, state, spec, b_fm, b_rcs = small_problem
    S = cov_direct.assemble_reduced_dense(fmp, b_fm)
    Qred = cov_direct.reduced_inverse(S)
    Qall = np.asarray(cov_direct.point_covariance_dense(fmp, b_fm, Qred))
    G2 = Qred.shape[0] - 6 * fmp.num_images
    h2, hi, hg = cov_direct.recovery_rows(fmp, b_fm)
    chunk = 32
    nch = fmp.num_points // chunk
    rows = np.asarray(cov_direct.point_cov_group(
        fmp, h2, hi, hg, Qred, G2, jnp.int32(0), chunk, nch))
    assert rows.shape == (6, fmp.num_points)
    np.testing.assert_allclose(rows[0], Qall[:, 0, 0], rtol=1e-10)
    np.testing.assert_allclose(rows[1], Qall[:, 0, 1], rtol=1e-9,
                               atol=1e-14)
    np.testing.assert_allclose(rows[5], Qall[:, 2, 2], rtol=1e-10)
    # split across two group dispatches
    half = nch // 2
    r1 = np.asarray(cov_direct.point_cov_group(
        fmp, h2, hi, hg, Qred, G2, jnp.int32(0), chunk, half))
    r2 = np.asarray(cov_direct.point_cov_group(
        fmp, h2, hi, hg, Qred, G2, jnp.int32(half), chunk, nch - half))
    np.testing.assert_allclose(np.concatenate([r1, r2], axis=1), rows,
                               rtol=1e-12)


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_bench_cov_programs_match_gather_recovery(small_problem, path):
    """The bench's covariance programs — one fused program, or the staged
    programs (sparse pair-block corrections, donated inverse, grouped
    recovery) — give the blocks of the one-shot gather recovery, in f64."""
    import bench as B
    from bundle_adjustment_tpu.parallel import cov_direct

    problem, fmp, state, spec, b_fm, _ = small_problem
    Qred = cov_direct.reduced_inverse(
        cov_direct.assemble_reduced_dense(fmp, b_fm))
    ref = np.asarray(cov_direct.point_covariance_dense(
        fmp, b_fm, Qred, point_ids=np.arange(fmp.num_points)))
    if path == "fused":
        Q = np.asarray(B.cov_fused(fmp, spec)(state))
    else:
        r = np.asarray(B.cov_staged(fmp, spec)(state))
        Q = np.stack([np.stack([r[0], r[1], r[2]], axis=1),
                      np.stack([r[1], r[3], r[4]], axis=1),
                      np.stack([r[2], r[4], r[5]], axis=1)], axis=1)
    assert Q.shape == ref.shape and Q.dtype == np.float64
    np.testing.assert_allclose(Q, ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("share,path", [(1e9, "fused"), (0.0, "staged")])
def test_bench_cov_phase_path_and_nonfinite_failure(small_problem, share,
                                                    path, monkeypatch):
    """bench (d) takes the path its memory estimate allows, records every
    block finite at a good state, and fails the run when a block is
    not finite."""
    import bench as B

    problem, fmp, state, spec, b_fm, _ = small_problem
    monkeypatch.setattr(B, "FUSED_COV_SHARE", share)
    G = int(fmp.free_global.shape[0])
    N = int(fmp.obs_x.shape[0])
    out = B._cov_phase({}, {}, fmp, state, spec, fmp.num_images, G, N,
                       None)
    assert out["cov_path"] == path and out["cov_dtype"] == "float64"
    assert out["cov_nonfinite_blocks"] == 0
    bad = state._replace(points=state.points.at[5, 0].set(jnp.nan))
    with pytest.raises(RuntimeError, match="not finite"):
        B._cov_phase({}, {}, fmp, bad, spec, fmp.num_images, G, N, None)
