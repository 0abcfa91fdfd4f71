"""Dense linear-algebra utilities.

The reference's numerics core (`adjustment/MathExtension.java`, survey A1/A2)
wraps packed LAPACK routines; here the same surface maps onto XLA's native
linalg (Cholesky/LU/SVD/eigh run as compiled kernels — there are no Python
stand-ins in the compute path):

  solve/inv (dppsv/dpptri, dspsv/dsptri)  ->  solve_spd / inv_spd,
                                              solve_symmetric / inv_symmetric
  pinv/cond via SVD (:102-215)            ->  pinv / cond
  dspevx selected eigenpairs (:448-494)   ->  eig_selected
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_spd(N, n, *, lower=False):
    """SPD solve via Cholesky (the dppsv path, MathExtension.java:239-264)."""
    L = jnp.linalg.cholesky(N)
    y = jnp.linalg.solve(L, n)
    return jnp.linalg.solve(L.T, y)


def inv_spd(N):
    """SPD inverse via Cholesky (dpptrf/dpptri, MathExtension.java:297-331)."""
    L = jnp.linalg.cholesky(N)
    Linv = jnp.linalg.solve(L, jnp.eye(N.shape[-1], dtype=N.dtype))
    return Linv.T @ Linv


def solve_symmetric(N, n):
    """Symmetric-indefinite solve (the dspsv/Bunch-Kaufman path,
    MathExtension.java:338-366) — LU factorisation gives the identical
    solution for the bordered datum systems."""
    return jnp.linalg.solve(N, n)


def inv_symmetric(N):
    """Symmetric-indefinite inverse (dsptrf/dsptri,
    MathExtension.java:393-426)."""
    return jnp.linalg.inv(N)


def pinv(A, tol=None):
    """Moore-Penrose pseudo-inverse via SVD (MathExtension.java:139-215)."""
    return jnp.linalg.pinv(A, rtol=tol) if tol is not None else jnp.linalg.pinv(A)


def cond(A):
    """Spectral condition number via SVD (MathExtension.java:102-110)."""
    s = jnp.linalg.svd(A, compute_uv=False)
    return s[..., 0] / s[..., -1]


def eig_selected(N, il: int, iu: int):
    """Selected eigenpairs il..iu (1-based, ascending) of a symmetric matrix
    (the dspevx path, MathExtension.java:448-494).

    XLA's eigh computes the full decomposition; the requested window is
    sliced out — identical results, batched/compiled execution."""
    w, v = jnp.linalg.eigh(N)
    return w[..., il - 1:iu], v[..., :, il - 1:iu]
