"""Large-scale LM driver: the reference's damping semantics over the RCS path.

`solver/adjustment.BundleAdjustment` is the dense parity engine; this is its
large-scale counterpart operating on an RCSProblem: the same
Levenberg-Marquardt bookkeeping (multiplicative damping, alpha-scaled steps,
0.2x/5x gain schedule on Omega, step rejection, damping shutoff,
convergence on max|dx| — survey F1/F8) driving the implicit-Schur PCG inner
solver, with optional checkpointing.

Note the convergence criterion at scale: the reference's sqrt(eps_f64)
threshold is unreachable in f32; the default tolerance here is scaled to the
working dtype (sqrt of its machine epsilon).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.problem import ParamState
from ..solver.adjustment import BundleAdjustment as _DenseBundleAdjustment
from ..solver.adjustment import lm_gain_update as _lm_gain_update
from . import rcs


@dataclass
class RCSResult:
    state: ParamState
    converged: bool
    iterations: int
    omega: float
    max_abs_dx: float
    history: list = field(default_factory=list)
    # EstimationState-style status taxonomy (EstimationStateType.java:24-60)
    status: "EstimationState" = None

    def __post_init__(self):
        if self.status is None:
            from ..solver.adjustment import EstimationState

            self.status = (EstimationState.ERROR_FREE_ESTIMATION
                           if self.converged
                           else EstimationState.NO_CONVERGENCE)


def solve(problem: rcs.RCSProblem, state: ParamState, spec,
          damping: float = 0.0,
          max_iterations: int = 100,
          tolerance: Optional[float] = None,
          cg_tol: float = 1e-6,
          cg_maxiter: int = 100,
          matvec_factory: Optional[Callable] = None,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0,
          verbose: bool = False,
          simulation: bool = False,
          listeners: Optional[list] = None,
          interrupted: Optional[Callable[[], bool]] = None) -> RCSResult:
    """Run the LM loop to convergence on a large-scale problem.

    ``matvec_factory(blocks) -> matvec``: optional per-iteration S@x
    override (a different implementation of the product on the same
    blocks; the low-rank extras corrections wrap it).
    ``simulation``: EstimationType.SIMULATION semantics — the right-hand
    side is zeroed so every step is exactly 0 and Omega = 0; the machinery
    (and covariance recovery on the unchanged state) still runs — pure
    variance propagation for network design (BundleAdjustment.java:830-831).
    ``listeners``: callbacks ``fn(name, old, new)`` fired with the
    reference's PropertyChange event names (ITERATE per iteration with
    (max_iterations, k), LEVENBERG_MARQUARDT_STEP with (lambda_old,
    lambda_new), CONVERGENCE with (tolerance, max_dx), INTERRUPT,
    NO_CONVERGENCE — EstimationStateType.java:24-60).
    ``interrupted``: zero-arg callable polled once per iteration; True
    stops the loop cooperatively with status INTERRUPT
    (BundleAdjustment.java:1455-1457).
    """
    from ..solver.adjustment import EstimationState
    from . import bigargs

    dtype = state.points.dtype
    # host (numpy) arrays go to the device once; the big ones travel as jit
    # arguments, not embedded constants
    problem = jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
        problem)
    big_names, big_vals = bigargs.split_big(problem)

    def _problem(big_):
        return bigargs.merge(problem, big_names, big_)

    if tolerance is None:
        tolerance = float(np.sqrt(np.finfo(np.dtype(dtype.name)).eps))

    def fire(name, old, new):
        for fn in (listeners or ()):
            fn(name, old, new)

    if simulation:
        # zero rhs => dx = 0 exactly; validate one linearisation pass so
        # singular geometry still surfaces, then report the zero result.
        # Event stream: one ITERATE (the single validation pass) followed by
        # CONVERGENCE, mirroring the reference's SIMULATION loop which still
        # iterates once (BundleAdjustment.java:830-831); checkpointing is a
        # no-op here — the state never changes, so there is nothing to
        # resume from.
        fire("ITERATE", max_iterations, 1)
        dxp, dxc, dxg, b, cg_it, ext = jax.jit(
            lambda big_, st: rcs.lm_step_full(_problem(big_), st, spec,
                                              jnp.asarray(0.0, dtype),
                                              cg_tol=cg_tol, cg_maxiter=0))(
            big_vals, state)
        ok = bool(np.isfinite(np.asarray(b.omega0)))
        fire("CONVERGENCE", tolerance, 0.0)
        return RCSResult(state=state, converged=ok, iterations=0,
                         omega=0.0, max_abs_dx=0.0,
                         history=[{"iter": 0, "max_dx": 0.0, "damping": 0.0,
                                   "cg_it": 0, "omega0": 0.0}],
                         status=(EstimationState.ERROR_FREE_ESTIMATION
                                 if ok else EstimationState.SINGULAR_MATRIX))

    adapted = float(damping)
    omega_prev = 0.0
    last_valid_dx = 0.0
    history = []

    @jax.jit
    def step_fn(big_, st, lam):
        return rcs.lm_step_full(_problem(big_), st, spec, lam, cg_tol=cg_tol,
                                cg_maxiter=cg_maxiter,
                                matvec_factory=matvec_factory)

    @jax.jit
    def omega_fn(big_, b, ext, dxp, dxc, dxg):
        return rcs.omega_at_full(_problem(big_), b, ext, dxp, dxc, dxg)

    @jax.jit
    def apply_fn(st, dxp, dxc, dxg, alpha):
        return rcs.apply_step(st, problem,
                              alpha * dxp, alpha * dxc, alpha * dxg)

    converged = False
    it_done = 0
    max_dx = float("inf")
    for k in range(max_iterations):
        it_done = k + 1
        fire("ITERATE", max_iterations, it_done)
        lam = jnp.asarray(adapted, dtype)
        dxp, dxc, dxg, b, cg_it, ext = step_fn(big_vals, state, lam)

        rejected = False
        alpha = 1.0
        if adapted > 0:
            alpha = min(0.25 * adapted ** -0.05, 0.75)
            cur = float(omega_fn(big_vals, b, ext, alpha * dxp, alpha * dxc,
                                 alpha * dxg))
            lam_old = adapted
            # shared reference schedule incl. the 1/sqrt(eps) runaway cap +
            # Omega reset (BundleAdjustment.java:403-415)
            adapted, omega_prev, accepted = _lm_gain_update(
                adapted, omega_prev, cur)
            if not accepted:
                rejected = True
                max_dx = last_valid_dx
            fire("LEVENBERG_MARQUARDT_STEP", lam_old, adapted)

        if not rejected:
            state, mdx = apply_fn(state, dxp, dxc, dxg,
                                  jnp.asarray(alpha, dtype))
            max_dx = float(mdx)
            last_valid_dx = max_dx
            if omega_prev == 0.0:
                omega_prev = float(b.omega0)

        history.append({"iter": it_done, "max_dx": max_dx,
                        "damping": adapted, "cg_it": int(cg_it),
                        "omega0": float(b.omega0)})
        if verbose:
            print(f"it={it_done} max|dx|={max_dx:.3e} lam={adapted:.2e} "
                  f"cg={int(cg_it)} omega0={float(b.omega0):.4e}")

        if checkpoint_path and checkpoint_every and it_done % checkpoint_every == 0:
            from ..solver.checkpoint import LMCheckpoint

            LMCheckpoint(state=state, iteration=it_done,
                         adapted_damping=adapted, omega=omega_prev,
                         max_abs_dx=max_dx).save(checkpoint_path)

        if interrupted is not None and interrupted():
            fire("INTERRUPT", False, True)
            return RCSResult(state=state, converged=False,
                             iterations=it_done, omega=omega_prev,
                             max_abs_dx=max_dx, history=history,
                             status=EstimationState.INTERRUPT)

        if not np.isfinite(max_dx):
            fire("SINGULAR_MATRIX", False, True)
            return RCSResult(state=state, converged=False, iterations=it_done,
                             omega=omega_prev, max_abs_dx=max_dx,
                             history=history,
                             status=EstimationState.SINGULAR_MATRIX)
        if max_dx <= tolerance and adapted == 0:
            converged = True
            fire("CONVERGENCE", tolerance, max_dx)
            break
        fire("CONVERGENCE", tolerance, max_dx)
        if adapted <= tolerance or k > max_iterations * 0.5:
            adapted = 0.0

    if not converged:
        fire("NO_CONVERGENCE", tolerance, max_dx)
    return RCSResult(state=state, converged=converged, iterations=it_done,
                     omega=omega_prev, max_abs_dx=max_dx, history=history)


class ScaleBundleAdjustment(_DenseBundleAdjustment):
    """The reference `BundleAdjustment` user API (setters, listeners,
    interrupt, SIMULATION, result writers — BundleAdjustment.java:652-665,
    1123-1199, 1455-1459) solved by the large-scale RCS engine instead of
    the dense bordered factorisation.

    Subclasses the dense solver and swaps its `_Kernels`:

    * intermediate iterations run `rcs.lm_step_full` (point-eliminated
      implicit-Schur PCG + exact low-rank extras) and scatter the step back
      into the dense column layout, so the parent's LM bookkeeping, event
      stream, interrupt, centroiding, checkpointing and writer export run
      unchanged (the F14/F15 surface is inherited, not re-implemented);
    * the FINAL stochastic pass (covariance by the requested
      MatrixInversion mode) keeps the parent's dense kernel — Qxx is dense
      by contract there.  At array scale (100k+ points) use `solve()` +
      parallel/cov_direct for block covariance recovery instead.
    """

    cg_tol: float = 1e-12
    cg_maxiter: int = 2000

    def _build_kernels(self):
        from ..solver.adjustment import EstimationType, _Kernels

        base = super()._build_kernels()
        bp = self.problem
        rp = rcs.rcs_from_problem(bp, dtype=self.dtype)
        spec = bp.spec
        simulation = self.estimation_type == EstimationType.SIMULATION
        T = bp.total_size
        C = bp.num_cameras
        K = spec.num_coefficients

        cols_p = jnp.asarray(np.asarray(bp.col_points).ravel())
        cols_e = jnp.asarray(np.asarray(bp.col_eo).ravel())
        cols_g = jnp.asarray(np.concatenate(
            [np.concatenate([bp.col_io[c], bp.col_dist[c]])
             for c in range(C)]))

        def to_flat(dxp, dxc, dxg):
            dx = jnp.zeros(T + 1, dxp.dtype)
            dx = dx.at[jnp.where(cols_p >= 0, cols_p, T)].set(dxp.ravel())
            dx = dx.at[jnp.where(cols_e >= 0, cols_e, T)].set(dxc.ravel())
            dx = dx.at[jnp.where(cols_g >= 0, cols_g, T)].set(dxg)
            return dx[:T]

        def solve_intermediate(state, damping):
            if simulation:
                return jnp.zeros(T, self.dtype)
            dxp, dxc, dxg, b, it, ext = rcs.lm_step_full(
                rp, state, spec, jnp.asarray(damping, self.dtype),
                cg_tol=self.cg_tol, cg_maxiter=self.cg_maxiter)
            return to_flat(dxp, dxc, dxg)

        solve_intermediate = jax.jit(solve_intermediate)

        def solve_final(state, damping):
            # dx by the scale engine, Qxx by the dense stochastic pass
            dx = solve_intermediate(state, damping)
            _, Q = base.solve_final(state, damping)
            return dx, Q

        return _Kernels(assemble=base.assemble, omega=base.omega,
                        solve_intermediate=solve_intermediate,
                        solve_final=solve_final)
