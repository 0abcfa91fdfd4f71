"""Scenario-batched calibration networks.

The expert-parallelism analogue for bundle adjustment (survey section 2.J,
BASELINE.json config 5): fleets of *independent* calibration networks with
identical shapes (same camera spec, same counts) are solved simultaneously
by vmapping the whole LM step over a leading scenario axis — one compiled
program, S networks per step, batched.  With a device
mesh, the scenario axis shards across devices (pure data parallelism, no
cross-scenario communication).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.problem import ParamState
from . import rcs


class ScenarioBatch(NamedTuple):
    """S independent problems with identical static shape.

    The index arrays (obs_point/obs_image/tables) are shared — scenarios
    differ in observations and parameter values only, the common case for
    repeated calibrations of the same rig/target field."""

    problem: rcs.RCSProblem  # index arrays shared across scenarios
    obs_xy: jnp.ndarray  # [S, N, 2] per-scenario observations
    obs_weight: jnp.ndarray  # [S, N, 2, 2]
    states: ParamState  # leading scenario axis on every block


def _one_step(problem, spec, damping, cg_tol, cg_maxiter):
    def step(obs_xy, obs_weight, state: ParamState):
        p = problem._replace(obs_xy=obs_xy, obs_weight=obs_weight)
        dxp, dxc, dxg, blocks, it = rcs.lm_step(
            p, state, spec, damping, cg_tol=cg_tol, cg_maxiter=cg_maxiter)
        new_state, max_dx = rcs.apply_step(state, p, dxp, dxc, dxg)
        return new_state, max_dx, blocks.omega0, it

    return step


def scenario_lm_step(batch: ScenarioBatch, spec, damping,
                     cg_tol=1e-8, cg_maxiter=100):
    """One LM iteration for every scenario simultaneously.

    Returns (new_states, max_dx [S], omega0 [S], cg_iters [S])."""
    step = _one_step(batch.problem, spec, damping, cg_tol, cg_maxiter)
    return jax.vmap(step)(batch.obs_xy, batch.obs_weight, batch.states)


def make_batch(problem: rcs.RCSProblem, obs_xy_batch, obs_weight_batch,
               states: ParamState) -> ScenarioBatch:
    return ScenarioBatch(problem=problem,
                         obs_xy=jnp.asarray(obs_xy_batch),
                         obs_weight=jnp.asarray(obs_weight_batch),
                         states=states)
