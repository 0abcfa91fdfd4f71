"""Batched EO-block Schur complement.

The reference eliminates each image's exterior-orientation block sequentially
(`reduceNormalEquationSystem`, BundleAdjustment.java:1197-1342) and
back-substitutes per image (`extractReducedParameters`, :1344-1453).  Because
EO blocks of different images never couple (no observation involves two
images) and each elimination only updates retained x retained entries, the
sequential loop is mathematically one *global* block elimination with a
block-diagonal N22 — which is what we compute here, batched:

    S  = N11 - N12 * blockdiag(inv N22_m) * N21      (one big matmul)
    nr = n1  - N12 * blockdiag(inv N22_m) * n2
    dx2_m = inv(N22_m) (n2_m - N21_m dx1)            (batched back-subst.)

Note the elimination keeps the points (+ IO + distortion + datum rows) and
removes the cameras — the inverse of classical SfM point elimination — because
the fully populated *point* covariance is the product of interest.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class SchurFactors(NamedTuple):
    S: jnp.ndarray  # [nR, nR] reduced system
    nr: jnp.ndarray  # [nR]
    inv22: jnp.ndarray  # [M, 6, 6] per-image inverse EO blocks (masked)
    n2: jnp.ndarray  # [M, 6]
    N12: jnp.ndarray  # [nR, M, 6] coupling blocks (masked)
    ec: jnp.ndarray  # [M, 6] EO column indices (clamped)
    mask: jnp.ndarray  # [M, 6] valid-EO mask


def reduce_eo(N, n, col_eo, n_reduced: int) -> SchurFactors:
    """Schur-reduce all EO columns out of the bordered system.

    N, n     : preconditioned bordered system ([T, T], [T])
    col_eo   : [M, 6] global EO columns, -1 where fixed
    n_reduced: size of the retained leading block
               (d + 3P + free IO + free distortion)
    """
    mask = col_eo >= 0  # [M, 6]
    ec = jnp.where(mask, col_eo, 0)

    # N22 blocks, masked: identity in fixed slots keeps them invertible and
    # inert (their coupling columns are zeroed below).
    N22 = N[ec[:, :, None], ec[:, None, :]]  # [M, 6, 6]
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = jnp.eye(6, dtype=N.dtype)
    N22 = jnp.where(m2, N22, eye)
    inv22 = jnp.linalg.inv(N22)
    inv22 = jnp.where(m2, inv22, 0.0)

    n2 = jnp.where(mask, n[ec], 0.0)  # [M, 6]

    N12 = N[:n_reduced, :][:, ec.reshape(-1)].reshape(n_reduced, -1, 6)
    N12 = jnp.where(mask[None, :, :], N12, 0.0)  # [nR, M, 6]

    W = jnp.einsum("rmi,mij->rmj", N12, inv22)  # [nR, M, 6]
    M_ = N12.shape[1]
    S = N[:n_reduced, :n_reduced] - jnp.dot(
        W.reshape(n_reduced, M_ * 6), N12.reshape(n_reduced, M_ * 6).T
    )
    nr = n[:n_reduced] - W.reshape(n_reduced, -1) @ n2.reshape(-1)
    return SchurFactors(S=S, nr=nr, inv22=inv22, n2=n2, N12=N12, ec=ec, mask=mask)


def back_substitute(f: SchurFactors, dx1) -> jnp.ndarray:
    """dx2 blocks [M, 6] from the retained solution dx1 [nR]
    (extractReducedParameters, BundleAdjustment.java:1344-1453)."""
    rhs = f.n2 - jnp.einsum("rmi,r->mi", f.N12, dx1)
    dx2 = jnp.einsum("mij,mj->mi", f.inv22, rhs)
    return jnp.where(f.mask, dx2, 0.0)


def assemble_full_dx(f: SchurFactors, dx1, total_size: int) -> jnp.ndarray:
    """Scatter (dx1, dx2) into the full bordered solution vector [T]."""
    dx = jnp.zeros(total_size, dx1.dtype)
    dx = dx.at[: dx1.shape[0]].set(dx1)
    dx2 = back_substitute(f, dx1)
    dx = dx.at[f.ec.reshape(-1)].add(jnp.where(f.mask, dx2, 0.0).reshape(-1))
    return dx
