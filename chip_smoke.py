"""Chip smoke: the solver's main path on the GPU, each result checked.

    python chip_smoke.py                # phases A and B on one card
    python chip_smoke.py --four-cards   # only the sharded step, four cards

Phase A, the dense f64 parity path: `BundleAdjustment.estimate_model` on a
synthetic metrology network (1 camera, 150 images, 2,000 points, a scale
bar, the inner-constraint datum, REDUCED inversion), compared with the same
solve on the CPU backend in this process: relative 1e-8 on the parameters,
on sigma0 and on the covariance diagonal.

Phase B, the scale path at BASELINE config 4 (100k points, 500 images, 12
views; 1.2M observations): the f32 `engine.lm_step` loop and the f64
`Refiner` to max|dx| <= 1e-6 (as `bench.run_suite` (a) runs them), then
every point's 3x3 covariance block by `cov_direct` in f64 at the refined
state (`bench.cov_fused`, as bench (d) runs it at config 4).  Checks: an
independent f64 solve of the same problem by `parallel.solver.solve`
(block layout, `rcs.py`) agrees to max|dpoint| <= 1e-5 and sigma0^2 to
1e-6 relative; every covariance block is finite, and 256 sampled blocks
agree with the matrix-free f64 PCG recovery
(`parallel.covariance.point_covariance_blocks`) to 1e-3 relative Frobenius
error.  The phase also records the XLA Schur matvec's time per call and
bytes/s (`bench.matvec_cost`).

``--four-cards``: the three sharded variants of
`__graft_entry__.dryrun_multichip` (data-parallel block layout,
point-sharded feature-major step, camera-sharded tensor-parallel step) on a
4-card mesh at config-4 width, each against the single-device engine step
on card 0.

One process; any platform but ``gpu`` is refused.  Each phase prints one
line with its errors next to their tolerances, seconds, compile seconds and
the process's peak device memory so far; an earlier line gives each card's
name and power limit (nvidia-smi).  A failed check raises, so the script
exits non-zero and prints no result; the last line on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import bench
from bundle_adjustment_tpu import compile_cache, device

# JAX's compile-path events: trace, lowering and backend compile
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_event(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


class Clock:
    """Wall seconds and compile seconds of one phase."""

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), _compile_s[0]
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.compile_seconds = _compile_s[0] - self.c0
        return False


def _rel(a, b):
    """max|a - b| / max|b| over the whole array."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _check(name, errors):
    """``errors``: {label: (error, tolerance)}; raises on any excess."""
    bad = {k: v for k, v in errors.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{name}: " + ", ".join(
            f"{k} {e:.3e} > {t:.0e}" for k, (e, t) in bad.items()))


def _report(name, errors, clock, extra=""):
    peak = device.peak_bytes()
    peak_s = "n/a" if peak is None else f"{peak / 2**30:.2f} GiB"
    errs = ", ".join(f"{k} {e:.3e} (tol {t:.0e})"
                     for k, (e, t) in errors.items())
    print(f"phase {name}: {errs}; {clock.seconds:.1f} s, compile "
          f"{clock.compile_seconds:.1f} s, peak device memory {peak_s}"
          + (f"; {extra}" if extra else ""), flush=True)


# ---------------------------------------------------------------------------
# phase A: dense f64 parity path, GPU vs CPU
# ---------------------------------------------------------------------------

def _dense_solve(num_points, num_images, seed):
    from bundle_adjustment_tpu import BundleAdjustment, MatrixInversion
    from bundle_adjustment_tpu.solver.adjustment import EstimationState
    from bundle_adjustment_tpu.testing import make_synthetic_scene

    cameras, scale_bars, _ = make_synthetic_scene(
        num_points=num_points, num_images=num_images, noise=5e-4,
        sigma=5e-4, perturb=0.01, seed=seed, with_scale_bar=True)
    adj = BundleAdjustment()
    for c in cameras:
        adj.add(c)
    for s in scale_bars:
        adj.add(s)
    adj.set_invert_normal_equation(MatrixInversion.REDUCED)
    status = adj.estimate_model()
    if status != EstimationState.ERROR_FREE_ESTIMATION:
        raise AssertionError(f"phase A: estimate_model ended {status.name}")
    return adj


def phase_a(num_points=2000, num_images=150, seed=11):
    """Dense REDUCED solve on the default device vs the CPU backend."""
    import jax

    with Clock() as clock:
        adj = _dense_solve(num_points, num_images, seed)
        with jax.default_device(jax.devices("cpu")[0]):
            ref = _dense_solve(num_points, num_images, seed)
    p = adj.problem
    d, nR = p.defect, p.reduced_size
    errors = {
        **{f"{f} rel": (_rel(getattr(adj.state, f), getattr(ref.state, f)),
                        1e-8) for f in ("points", "io", "dist", "eo")},
        "sigma0 rel": (abs(np.sqrt(adj.get_variance_factor_aposteriori())
                           / np.sqrt(ref.get_variance_factor_aposteriori())
                           - 1.0), 1e-8),
        "Qxx diag rel": (float(np.max(
            np.abs(np.diag(adj.Qxx)[d:nR] - np.diag(ref.Qxx)[d:nR])
            / np.abs(np.diag(ref.Qxx)[d:nR]))), 1e-8),
    }
    _report("A (dense f64, BundleAdjustment vs CPU)", errors, clock,
            f"{p.num_image_obs} image observations, {p.num_unknowns} "
            f"unknowns, {adj.iteration_step} iterations")
    _check("phase A", errors)
    return errors


# ---------------------------------------------------------------------------
# phase B: the scale path at config 4
# ---------------------------------------------------------------------------

def _frobenius_rel(Q, Qref):
    """Largest per-block relative Frobenius error of [k, 3, 3] blocks."""
    Q, Qref = np.asarray(Q, np.float64), np.asarray(Qref, np.float64)
    return float(np.max(np.sqrt(np.sum((Q - Qref) ** 2, axis=(1, 2))
                                / np.sum(Qref ** 2, axis=(1, 2)))))


def phase_b(num_points=100_000, num_images=500, views=12, n_cov=256,
            seed=0):
    """f32 LM + f64 refinement + f64 cov_direct vs the f64 block-layout
    solver and the matrix-free PCG covariance."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.parallel import (
        covariance, engine, rcs, refine, solver)

    f32 = jnp.float32
    with Clock() as clock:
        problem, state0, spec = bench.build_problem(
            num_points, num_images, views, f32, seed=seed)
        problem, state0, _ = engine.pad_problem(problem, state0)
        fmp = engine.fm_problem(problem)
        G = 3 + spec.num_coefficients

        # 1. f32 LM loop + f64 refinement (bench (a))
        _, lm = bench.make_lm(fmp, problem, spec, f32)
        state, _, n_f32, _ = bench.f32_phase(lm, state0)
        refiner = refine.Refiner(problem, spec)
        s64, n_ref, mdx, _ = bench.refine_phase(refiner, state)
        if not mdx <= 1e-6:
            raise AssertionError(f"phase B: refinement stopped at max|dx| "
                                 f"{mdx:.3e} > 1e-6")
        omega = float(refiner.omega(s64))

        # 2. every point's 3x3 covariance block by cov_direct, in f64 at
        # the refined state (bench (d))
        Q = np.asarray(bench.cov_fused(refiner.fmp64, spec)(s64))

        # the XLA matvec, as the CG loop runs it
        mv = bench.matvec_record(fmp, state, spec, G, views)

        # 3. the f64 reference solve of the same data (block layout)
        p64 = refine.upcast_problem(problem)
        st64 = jax.tree.map(lambda x: x.astype(jnp.float64), state0)
        res = solver.solve(p64, st64, spec, damping=0.0, max_iterations=30,
                           cg_tol=1e-10, cg_maxiter=2000)
        if not res.converged:
            raise AssertionError(f"phase B: f64 reference did not converge "
                                 f"(max|dx| {res.max_abs_dx:.3e})")
        lin64 = jax.jit(lambda st: rcs.linearize(p64, st, spec,
                                                 jnp.asarray(0.0)))
        omega_ref = float(lin64(res.state).omega0)

        # 4. reference covariance blocks at the scale path's state (f64 PCG)
        rng = np.random.default_rng(seed)
        ids = np.sort(rng.choice(num_points, min(n_cov, num_points),
                                 replace=False)).astype(np.int32)
        b64 = lin64(s64)
        pcg = jax.jit(lambda b, i: covariance.point_covariance_blocks(
            p64, b, i, tol=1e-10, maxiter=4000))
        Qref = np.concatenate([
            np.asarray(pcg(b64, jnp.asarray(ids[k:k + 32])))
            for k in range(0, ids.size, 32)])

    pts = np.asarray(s64.points)[:num_points]
    pts_ref = np.asarray(res.state.points)[:num_points]
    errors = {"max|dpoint|": (float(np.max(np.abs(pts - pts_ref))), 1e-5),
              "sigma0^2 rel": (abs(omega / omega_ref - 1.0), 1e-6),
              "non-finite cov blocks": (bench.nonfinite_blocks(Q), 0),
              "cov Frobenius rel": (_frobenius_rel(Q[ids], Qref), 1e-3)}
    _, fbytes = bench.matvec_cost(int(fmp.obs_x.shape[0]), G, views)
    _report("B (scale path, config 4)", errors, clock,
            f"{n_f32} f32 + {n_ref} f64 refine iterations to max|dx| "
            f"{mdx:.2e}, f64 reference {res.iterations} iterations, "
            f"{Q.shape[0]} f64 covariance blocks; XLA matvec "
            f"{mv['matvec_xla_ms']} ms/call, {mv['matvec_xla_gbps']} GB/s "
            f"of {fbytes / 1e6:.1f} MB/call")
    _check("phase B", errors)
    return errors


# ---------------------------------------------------------------------------
# --four-cards: the sharded LM step
# ---------------------------------------------------------------------------

def phase_four_cards(n_devices=4, num_points=100_000, num_images=500,
                     views=12):
    """The three sharded variants of dryrun_multichip vs the single-device
    engine step."""
    import __graft_entry__

    with Clock() as clock:
        results = __graft_entry__.dryrun_multichip(
            n_devices, num_points=num_points, num_images=num_images,
            views=views)
    errors = {f"{tag} points": (r["point_err"], r["point_tol"])
              for tag, r in results.items()}
    errors.update({f"{tag} omega0 rel": (r["omega_rel"], r["omega_tol"])
                   for tag, r in results.items()})
    _report(f"four-cards ({n_devices}-device mesh, {num_points} points)",
            errors, clock)
    _check("four-cards", errors)
    return errors


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if four and len(devs) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs; JAX found "
              f"{len(devs)}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    compile_cache.enable()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    for card in device.gpu_cards():
        print(card, flush=True)

    if four:
        phase_four_cards()
    else:
        phase_a()
        phase_b()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
