"""Refinement: f64 Gauss-Newton steps from the f32 LM phase's state.

The f32 LM loop floors at max|dx| ~ 1e-3..1e-2 * noise scale: the gradient
g = J^T P w is a massively cancelling reduction, so near the optimum f32
rounding noise (amplified through S^{-1}) dominates the step, and the f32
state's quantisation eps*|x| (~2e-4 at km-scale coordinates) bounds the
step size it can take (survey hard-part 1; BundleAdjustment.java:77,332
for the reference's sqrt(eps_f64) criterion this must approach).

Refinement takes the state from that floor to f64 grade with plain f64
Gauss-Newton steps of the same feature-major engine (`engine.lm_step_full`:
f64 linearisation, reduction, block preconditioner and PCG on the implicit
Schur complement, scale bars and the inner-constraint datum included).
From the f32 floor each step contracts the error by the f64 CG solve's
relative accuracy: 3 steps take a 20k-point network from the floor to
max|dx| ~1e-9.

Why not classic mixed-precision refinement (f64 gradient, f32 solve)?  Its
contraction per step is bounded by the f32 operator's error times the
reduced system's condition number.  On the synthetic bench networks the
Jacobi-scaled reduced system has a condition number of ~1.6e7 (20k points,
100 images; the radial terms and the principal distance correlate), so
eps_f32 * cond ~ 1: the f32 solve contracts by only ~0.5-0.7 per step,
and in f32 the preconditioner's global Schur complement loses
definiteness (r^T M^{-1} r < 0 inside CG), which breaks CG's recurrences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.problem import ParamState
from . import bigargs, engine, rcs


def upcast_problem(problem: rcs.RCSProblem) -> rcs.RCSProblem:
    """f32 -> f64 copy of the float fields (indices untouched)."""
    def up(x):
        if hasattr(x, "dtype") and x.dtype == jnp.float32:
            return x.astype(jnp.float64)
        return x

    return jax.tree.map(up, problem)


def to_f64(state: ParamState) -> ParamState:
    return ParamState(*(jnp.asarray(a, jnp.float64) for a in state))


class Refiner:
    """Engine-path (feature-major) f64 refiner.

    Supports the full extras surface of the scale path: scale bars, Helmert
    inner-constraint datum (freenet low-rank corrections) and direct
    observations (folded by the lineariser) — BundleAdjustment.java:493-635,
    PartialDerivativeFactory.java:210-283,447-473.

    Usage:
        r = Refiner(problem32, spec)
        s, max_dx, omega0, it = r.step(state)   # f64 state out
        s, history = r.refine(state32)          # repeat until tolerance

    Everything runs on the default device in f64."""

    def __init__(self, problem32: rcs.RCSProblem, spec,
                 couple_global: bool = True):
        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "refinement needs jax_enable_x64=True for its f64 steps "
                "(f64 would silently truncate)")
        self.spec = spec
        self.couple_global = couple_global
        self.problem64 = upcast_problem(problem32)
        self.fmp64 = engine.fm_problem(self.problem64)
        # big problem arrays travel as jit ARGUMENTS, not embedded
        # constants (parallel/bigargs.py)
        self._names, self._vals = bigargs.split_big(self.fmp64)
        self._step = jax.jit(self._step_impl)
        self._omega = jax.jit(self._omega_impl)

    def _step_impl(self, big_, st: ParamState, damping, cg_tol, cg_maxiter):
        p = bigargs.merge(self.fmp64, self._names, big_)
        dxp, dxc, dxg, b, it, _ext = engine.lm_step_full(
            p, self.problem64, st, self.spec, damping, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter, couple_global=self.couple_global)
        new, max_dx = rcs.apply_step(st, self.problem64, dxp, dxc, dxg)
        return new, max_dx, b.omega0, it

    def _omega_impl(self, big_, st: ParamState):
        p = bigargs.merge(self.fmp64, self._names, big_)
        omega0 = engine.linearize(p, st, self.spec,
                                  jnp.asarray(0.0, jnp.float64)).omega0
        rp = self.problem64
        if getattr(rp, "sb_a", None) is not None and rp.sb_a.shape[0] > 0:
            dvec = st.points[rp.sb_b] - st.points[rp.sb_a]
            w = rp.sb_length - jnp.sqrt(jnp.sum(dvec * dvec, axis=1))
            omega0 = omega0 + jnp.sum(rp.sb_weight * w * w)
        if getattr(rp, "dpg_idx", None) is not None \
                and rp.dpg_idx.shape[0] > 0:
            cur = jnp.take_along_axis(st.points[rp.dpg_idx],
                                      rp.dpg_axis[:, None], axis=1)[:, 0]
            w = rp.dpg_val - cur
            omega0 = omega0 + jnp.dot(w, jnp.linalg.solve(rp.dpg_cov, w))
        return omega0

    def omega(self, state: ParamState):
        """f64 Omega = v^T P v at ``state`` (scale bars and direct point
        groups included)."""
        return self._omega(self._vals, to_f64(state))

    def step(self, state: ParamState, damping=0.0, cg_tol=1e-10,
             cg_maxiter=2000):
        """One f64 Gauss-Newton step from ``state`` (any float dtype).
        Returns (f64 state, max|dx|, Omega at ``state``, CG iterations).
        The controls are traced: one compiled program serves them all."""
        return self._step(self._vals, to_f64(state),
                          jnp.asarray(damping, jnp.float64),
                          jnp.asarray(cg_tol, jnp.float64),
                          jnp.asarray(cg_maxiter, jnp.int32))

    def refine(self, state: ParamState, tolerance: float = 1e-6,
               max_iterations: int = 8, **kw):
        """Step until max|dx| <= tolerance.  Returns (f64 state, history
        list of max|dx|)."""
        history = []
        for _ in range(max_iterations):
            state, max_dx, _omega0, _it = self.step(state, **kw)
            history.append(float(max_dx))
            if history[-1] <= tolerance:
                break
        return to_f64(state), history
