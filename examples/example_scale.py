"""Scale-path example: the reference workflow at 20k points on one device.

The reference's examples are object-graph pipelines (ExampleReport /
ExampleFlatFiles, survey I1-I3); this example shows the same user story at
a scale the dense solver cannot touch: a synthetic 20k-point / 100-image
network solved by the point-eliminated implicit-Schur engine
(`parallel.solver.solve`), refined to ~1e-6 absolute, with posterior
per-point sigmas recovered from the dense-factored reduced system
(`parallel.cov_direct`) — the REDUCED-inversion covariance story of
BundleAdjustment.java:255-298 re-designed for an accelerator.

Runs on CPU too (slower; pass a smaller size).  Usage:

    python examples/example_scale.py [num_points num_images views]
"""

import sys
import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)  # refinement is f64
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    import bench as B
    from bundle_adjustment_tpu.parallel import engine, refine, solver

    P = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    M = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    V = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    t0 = time.time()
    problem, state0, spec = B.build_problem(P, M, V, jnp.float32)
    # zero-weight dummy points up to a multiple of 128: cov_direct chunks
    # the point axis by divisors of P
    problem, state0, _ = engine.pad_problem(problem, state0)
    print(f"problem: P={problem.num_points} M={M} V={V} "
          f"({time.time() - t0:.1f}s to build)")

    # f32 LM phase with the reference's damping semantics + status events
    events = []
    res = solver.solve(problem, state0, spec, damping=1e-2,
                       max_iterations=40, cg_tol=1e-6, cg_maxiter=200,
                       listeners=[lambda n, o, v: events.append(n)])
    print(f"f32 phase: {res.iterations} iterations, "
          f"max|dx|={res.max_abs_dx:.2e}, status={res.status.name}")

    # f64 refinement to ~1e-6 absolute
    r = refine.Refiner(problem, spec)
    s, history = r.refine(res.state, tolerance=1e-6, max_iterations=8)
    print(f"refinement: {len(history)} iterations, "
          f"max|dx|={history[-1]:.2e}")

    # posterior covariance in f64 at the refined state: every point's 3x3
    # block from the factored reduced system (sigma0_post^2-scaled sigmas
    # like ExampleReport)
    Q = np.asarray(B.cov_fused(r.fmp64, spec)(s))
    if not np.isfinite(Q).all():
        raise RuntimeError("non-finite covariance blocks")
    sig = np.sqrt(np.abs(Q[:, [0, 1, 2], [0, 1, 2]]))
    free = np.asarray(problem.free_point)[:, 0] > 0
    print(f"point sigmas (cofactor): "
          f"RMS X/Y/Z = {np.sqrt((sig[free] ** 2).mean(axis=0))}")
    print(f"total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
