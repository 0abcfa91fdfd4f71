"""Tensor-parallel direct solve of the reduced camera system.

Survey section 2.J's TP row: "shard the reduced normal matrix /
factorization panels across devices".  The reference factorises its
(packed, dense) normal system with single-threaded LAPACK
(``MathExtension.java:239-426``); the flagship scale path avoids an explicit
reduced matrix entirely (implicit-Schur PCG, `parallel/rcs.py`).  This
module covers the ground between the two: an **explicit dense reduced
system** assembled in one batched pass, factorised by a **distributed
blocked right-looking Cholesky** whose row panels live on different
devices of a `jax.sharding.Mesh` — the array-native equivalent of a
ScaLAPACK ``pdpotrf``:

Two factorization bodies exist, dispatched by `cholesky_traced` on the
block count nb = n/block:

* ``_chol_cyclic`` (nb <= _MAX_UNROLL, the perf path): BLOCK-CYCLIC row
  distribution (device d owns global block rows k with k % D == d, the
  ScaLAPACK ``pdpotrf`` layout) with a Python-unrolled outer loop, so
  every trailing update is a STATIC SHRINKING slice — only rows/cols > k
  — and the per-device trailing work shrinks in step with the
  elimination.  Per block step: the owner's block row is replicated with
  one ``psum`` (masked contribution trick), every device solves its
  local panel against ``L_kk^{-T}``, one ``all_gather`` re-forms the
  column panel in natural order, and the trailing update is a local
  matmul over the remaining rows.  bench.py phase (e) times it against
  XLA's single-device Cholesky.
* ``_chol_local`` (nb > _MAX_UNROLL fallback): contiguous row panels +
  `lax.fori_loop` with full-width masked trailing updates — bounded
  compile time for very large nb at ~3x the useful flops.

Triangular solves stream block-wise with one small ``psum`` per step.
Memory per device is n^2/D.  `distributed_cholesky` wraps
`cholesky_traced` with explicit device placement for eager callers; use
`cholesky_traced` inside larger jitted programs (solver steps,
benchmarks).  Use the
implicit PCG (`rcs.pcg`) for the 100k+-point regime; use this for a
direct solve / dense factor of reduced systems that exceed a single
device or when a factor is wanted for many right-hand sides (covariance
columns).

Cross-checks: `tests/test_tp_cholesky.py` pins the distributed factor,
solve, and the assembled reduced system against `jnp.linalg` and the PCG
path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import rcs

# An f32 matmul without a stated precision may run in TF32 on the GPU (about
# three decimal digits): unacceptable for covariance / normal-equation
# products.  All value x value contractions here pin full f32.
_PREC = jax.lax.Precision.HIGHEST

AXIS = "tp"


def _i32(*idx):
    """dynamic_slice requires same-dtype indices; pin to int32 (x64-safe)."""
    return tuple(jnp.asarray(i, jnp.int32) for i in idx)


# ---------------------------------------------------------------------------
# explicit reduced system
# ---------------------------------------------------------------------------

def assemble_reduced_system(p: rcs.RCSProblem, b: rcs.Blocks):
    """Dense damped reduced (Schur) system over [cameras | globals].

    S = [[Scc, Scg], [Scg^T, Sgg]] with the point block eliminated:
    S** = H** - H*p Hpp^{-1} Hp* (BundleAdjustment.java:1197-1342 does the
    mirror-image elimination sequentially per image; here every block is
    one batched einsum + segment reduction).  Returns (S [u, u], r [u])
    with u = 6 M + G, camera-major.

    Memory: the camera-camera correction materialises [P, V, V, 6, 6]
    (V = uniform views per point) — intended for direct-solve scale
    (M up to a few thousand), not the 1M-point PCG regime.
    """
    if p.point_uniform is None:
        raise ValueError("assemble_reduced_system requires the uniform "
                         "point-major layout")
    M, G = p.num_images, b.Jg.shape[2]
    Pn, V = p.num_points, p.point_uniform
    # the [P, V, V, 6, 6] intermediate is intended for direct-solve scale;
    # fail early with a pointer instead of an allocator OOM at PCG scale
    if Pn * V * V > 200_000_000:
        raise ValueError(
            f"assemble_reduced_system intermediate [P={Pn}, V={V}, V, 6, 6] "
            "is too large to materialise; use rcs.pcg (implicit Schur) or "
            "engine.assemble_reduced_dense (chunked) at this scale")

    Hpc = jnp.einsum("nia,nib->nab", b.Jp, b.PJc)        # [N, 3, 6]
    Hpc_v = Hpc.reshape(Pn, V, 3, 6)
    Y_v = jnp.einsum("pab,pvbc->pvac", b.Hpp_inv, Hpc_v)  # Hpp^{-1} Hpc
    pair = jnp.einsum("pvab,pwac->pvwbc", Hpc_v, Y_v)     # [P, V, V, 6, 6]
    img = p.obs_image.reshape(Pn, V)
    ids = (img[:, :, None] * M + img[:, None, :]).reshape(-1)
    corr_cc = jax.ops.segment_sum(
        pair.reshape(-1, 6, 6), ids, num_segments=M * M).reshape(M, M, 6, 6)

    Hcc = rcs._seg_image(p, jnp.einsum("nia,nib->nab", b.Jc, b.PJc))
    Scc = -corr_cc
    diag = Hcc + b.extra_c[:, :, None] * jnp.eye(6, dtype=Hcc.dtype)
    Scc = Scc.at[jnp.arange(M), jnp.arange(M)].add(diag)

    # camera-global coupling
    Hpg = rcs._seg_point(p, jnp.einsum("nia,nib->nab", b.Jp, b.PJg))
    W = jnp.einsum("pab,pbg->pag", b.Hpp_inv, Hpg)        # [P, 3, G]
    Hcg = rcs._seg_image(p, jnp.einsum("nia,nib->nab", b.Jc, b.PJg))
    corr_cg = rcs._seg_image(
        p, jnp.einsum("nab,nag->nbg", Hpc, rcs._expand_point(p, W)))
    Scg = Hcg - corr_cg                                    # [M, 6, G]

    Hgg = jnp.einsum("nia,nib->ab", b.Jg, b.PJg) + jnp.diag(b.extra_g)
    Sgg = Hgg - jnp.einsum("pag,pab,pbh->gh", Hpg, b.Hpp_inv, Hpg)

    u = 6 * M + G
    S = jnp.zeros((u, u), Scc.dtype)
    S = S.at[:6 * M, :6 * M].set(
        Scc.transpose(0, 2, 1, 3).reshape(6 * M, 6 * M))
    S = S.at[:6 * M, 6 * M:].set(Scg.reshape(6 * M, G))
    S = S.at[6 * M:, :6 * M].set(Scg.reshape(6 * M, G).T)
    S = S.at[6 * M:, 6 * M:].set(Sgg)

    rc, rg = rcs.reduced_rhs(p, b)
    r = jnp.concatenate([rc.reshape(-1), rg])
    return S, r


def pad_spd(S, r, n_pad):
    """Pad an SPD system to size ``n_pad`` with an identity diagonal (the
    factor of the padding is the identity; padded rhs entries are zero)."""
    n = S.shape[0]
    if n_pad == n:
        return S, r
    Sp = jnp.eye(n_pad, dtype=S.dtype).at[:n, :n].set(S)
    return Sp, jnp.zeros(n_pad, r.dtype).at[:n].set(r)


# ---------------------------------------------------------------------------
# distributed blocked Cholesky
# ---------------------------------------------------------------------------

def _block_row(A, row0, n_loc, g0, bs, axis):
    """Replicate global block row [g0, g0+bs) of the row-sharded A with one
    masked-contribution psum."""
    n = A.shape[1]
    off = g0 - row0
    in_range = jnp.logical_and(off >= 0, off < n_loc)
    safe = jnp.clip(off, 0, n_loc - bs)
    Rk = jax.lax.dynamic_slice(A, _i32(safe, 0), (bs, n))
    Rk = jnp.where(in_range, Rk, jnp.zeros_like(Rk))
    return jax.lax.psum(Rk, axis)


def _chol_local(A, bs, axis):
    """shard_map body: in-place blocked right-looking Cholesky of the
    row-sharded SPD matrix.  A: [n_loc, n] local row panel; returns the
    local rows of L (strict upper zeroed)."""
    n_loc, n = A.shape
    nb = n // bs
    row0 = jax.lax.axis_index(axis) * n_loc
    rows = row0 + jnp.arange(n_loc)
    cols = jnp.arange(n)

    def body(k, A):
        g0 = k * bs
        Rk = _block_row(A, row0, n_loc, g0, bs, axis)
        Akk = jax.lax.dynamic_slice(Rk, _i32(0, g0), (bs, bs))
        Lkk = jnp.linalg.cholesky(Akk)
        # local factorization panel: W = A[:, g0:g0+bs] @ Lkk^{-T}
        Pan = jax.lax.dynamic_slice(A, _i32(0, g0), (n_loc, bs))
        Wp = jax.lax.linalg.triangular_solve(
            Lkk, Pan, left_side=False, lower=True, transpose_a=True)
        below = (rows >= g0 + bs)[:, None]
        in_blk = jnp.logical_and(rows >= g0, rows < g0 + bs)[:, None]
        Wb = jnp.where(below, Wp, 0.0)
        # panel write-back: below rows get W, in-block rows their Lkk row,
        # factored rows (strict upper of L) zero
        Lrows = Lkk[jnp.clip(rows - g0, 0, bs - 1)]
        panel_new = jnp.where(in_blk, Lrows, Wb)
        # trailing update: one all_gather of the column panel, then a
        # local [n_loc, bs] @ [bs, n] matmul masked to trailing columns
        Wfull = jax.lax.all_gather(Wb, axis, axis=0, tiled=True)  # [n, bs]
        colmask = (cols >= g0 + bs).astype(A.dtype)
        A = A - jnp.matmul(Wb, Wfull.T, precision=_PREC) * colmask[None, :]
        return jax.lax.dynamic_update_slice(A, panel_new, _i32(0, g0))

    return jax.lax.fori_loop(0, nb, body, A)


def _solve_local(L, r, bs, axis):
    """shard_map body: y = L^{-1} r then x = L^{-T} y, block-streaming.
    L: [n_loc, n] local rows of the factor; r: [n, k] replicated right-hand
    sides.  Returns the replicated solution [n, k]."""
    n_loc, n = L.shape
    nb = n // bs
    row0 = jax.lax.axis_index(axis) * n_loc
    rows = row0 + jnp.arange(n_loc)
    cols = jnp.arange(n)

    nrhs = r.shape[1]

    def fwd(k, y):
        g0 = k * bs
        Rk = _block_row(L, row0, n_loc, g0, bs, axis)
        Lkk = jax.lax.dynamic_slice(Rk, _i32(0, g0), (bs, bs))
        rk = jax.lax.dynamic_slice(r, _i32(g0, 0), (bs, nrhs))
        acc = jnp.matmul(Rk, jnp.where(cols[:, None] < g0, y, 0.0),
                         precision=_PREC)
        yk = jax.lax.linalg.triangular_solve(
            Lkk, rk - acc, left_side=True, lower=True)
        return jax.lax.dynamic_update_slice(y, yk, _i32(g0, 0))

    y = jax.lax.fori_loop(0, nb, fwd, jnp.zeros_like(r))

    def bwd(i, x):
        k = nb - 1 - i
        g0 = k * bs
        Rk = _block_row(L, row0, n_loc, g0, bs, axis)
        Lkk = jax.lax.dynamic_slice(Rk, _i32(0, g0), (bs, bs))
        # c = sum over rows below the block of L[i, g0:g0+bs]^T x[i]
        Pan = jax.lax.dynamic_slice(L, _i32(0, g0), (n_loc, bs))
        xloc = jax.lax.dynamic_slice(x, _i32(row0, 0), (n_loc, nrhs))
        mask = (rows >= g0 + bs).astype(L.dtype)
        c = jax.lax.psum(jnp.matmul(Pan.T, xloc * mask[:, None],
                                    precision=_PREC), axis)
        yk = jax.lax.dynamic_slice(y, _i32(g0, 0), (bs, nrhs))
        xk = jax.lax.linalg.triangular_solve(
            Lkk, yk - c, left_side=True, lower=True, transpose_a=True)
        return jax.lax.dynamic_update_slice(x, xk, _i32(g0, 0))

    return jax.lax.fori_loop(0, nb, bwd, jnp.zeros_like(r))


def _check_dims(n, D, block):
    if n % (D * block) != 0 or (n // D) % block != 0:
        raise ValueError(
            f"matrix size {n} must be a multiple of mesh size {D} x "
            f"block {block} with block dividing the local row count "
            f"(pad with pad_spd)")


#: unroll limit for the shrinking (block-cyclic) factorization; above it
#: the masked fori_loop fallback keeps compile time bounded
_MAX_UNROLL = 64


def _chol_cyclic(A, bs, axis, D):
    """shard_map body: blocked right-looking Cholesky with BLOCK-CYCLIC row
    distribution and a Python-unrolled outer loop, so every trailing update
    is a STATIC shrinking slice — [rows > k, cols > k] only — instead of
    the fori_loop fallback's full-width masked matmul (~3x the useful
    flops).

    ``A``: [nbl*bs, n] local rows; local block j holds GLOBAL block row
    j*D + d (cyclic), so the per-device trailing row count shrinks in step
    with the elimination — the ScaLAPACK pdpotrf distribution."""
    n_loc, n = A.shape
    nbl = n_loc // bs
    nb = nbl * D
    d = jax.lax.axis_index(axis)
    Ab = A.reshape(nbl, bs, n)

    for k in range(nb):
        g0 = k * bs
        owner = k % D
        jloc = k // D      # local index of global block k on its owner
        own = (d == owner)

        # replicate the owner's current block row (trailing columns only)
        Rk = jax.lax.psum(
            jnp.where(own, Ab[jloc, :, g0:], 0.0), axis)     # [bs, n-g0]
        Lkk = jnp.linalg.cholesky(Rk[:, :bs])

        # local factorization panel over blocks that can still be trailing
        jsl = (k + 1) // D
        tb = nbl - jsl
        if tb > 0:
            Pan = Ab[jsl:, :, g0:g0 + bs]                    # [tb, bs, bs]
            gids = jnp.arange(jsl, nbl) * D + d
            tmask = (gids > k).astype(A.dtype)[:, None, None]
            W = jax.lax.linalg.triangular_solve(
                Lkk, Pan.reshape(tb * bs, bs), left_side=False, lower=True,
                transpose_a=True).reshape(tb, bs, bs) * tmask
        else:
            W = jnp.zeros((0, bs, bs), A.dtype)

        if k + 1 < nb:
            # natural-order global trailing panel: gather, interleave the
            # cyclic blocks back to (j, d)-order, drop the <= k blocks
            Wall = jax.lax.all_gather(W, axis, axis=0)       # [D, tb, bs, bs]
            Wnat = Wall.transpose(1, 0, 2, 3).reshape(tb * D * bs, bs)
            drop = (k + 1 - jsl * D) * bs
            Wtrail = Wnat[drop:]                             # [(nb-k-1)bs, bs]
            upd = jnp.matmul(W.reshape(tb * bs, bs), Wtrail.T,
                             precision=_PREC)
            Ab = Ab.at[jsl:, :, g0 + bs:].add(
                -upd.reshape(tb, bs, (nb - k - 1) * bs))

        # factor write-back: trailing blocks get W (finalised rows among
        # them get 0 — their strict upper), the owner's block row gets Lkk
        # with its trailing columns zeroed
        if tb > 0:
            Ab = Ab.at[jsl:, :, g0:g0 + bs].set(W)
        Ab = Ab.at[jloc, :, g0:g0 + bs].set(
            jnp.where(own, Lkk, Ab[jloc, :, g0:g0 + bs]))
        Ab = Ab.at[jloc, :, g0 + bs:].set(
            jnp.where(own, 0.0, Ab[jloc, :, g0 + bs:]))

    return Ab.reshape(n_loc, n)


def _cyclic_perm(nb, D):
    """Natural block order -> cyclic placement: position d*nbl + j holds
    global block j*D + d (device d's contiguous shard = its cyclic set)."""
    nbl = nb // D
    return np.array([j * D + d for d in range(D) for j in range(nbl)])


def cholesky_traced(S, mesh: Mesh, axis: str = AXIS, block: int = 8):
    """Traceable (jit-composable) body of `distributed_cholesky`: takes and
    returns the natural-row-order matrix with a row-sharded layout
    constraint.  Use this inside a larger jitted program (e.g. a chained
    benchmark or a solver step); `distributed_cholesky` wraps it with the
    device placement."""
    D = mesh.shape[axis]
    n = S.shape[0]
    _check_dims(n, D, block)
    nb = n // block
    if nb > _MAX_UNROLL:
        f = jax.shard_map(lambda A: _chol_local(A, block, axis), mesh=mesh,
                          in_specs=(P(axis, None),), out_specs=P(axis, None),
                          check_vma=False)
        return f(jax.lax.with_sharding_constraint(
            S, NamedSharding(mesh, P(axis, None))))

    perm = _cyclic_perm(nb, D)
    inv = np.argsort(perm)
    f = jax.shard_map(lambda A: _chol_cyclic(A, block, axis, D), mesh=mesh,
                      in_specs=(P(axis, None),), out_specs=P(axis, None),
                      check_vma=False)
    Sc = S.reshape(nb, block, n)[perm].reshape(n, n)
    Sc = jax.lax.with_sharding_constraint(
        Sc, NamedSharding(mesh, P(axis, None)))
    Lc = f(Sc)
    L = Lc.reshape(nb, block, n)[inv].reshape(n, n)
    return jax.lax.with_sharding_constraint(
        L, NamedSharding(mesh, P(axis, None)))


def distributed_cholesky(S, mesh: Mesh, axis: str = AXIS, block: int = 8):
    """Row-sharded blocked Cholesky: returns L (lower, same sharding,
    natural row order).  Internally the factorization runs on a
    block-cyclic row distribution with statically shrinking trailing
    updates (`_chol_cyclic`); the two row permutations are device-side
    gathers.  Falls back to the masked fori_loop kernel when the block
    count exceeds the unroll budget."""
    _check_dims(S.shape[0], mesh.shape[axis], block)
    S = jax.device_put(S, NamedSharding(mesh, P(axis, None)))
    return jax.jit(lambda S_: cholesky_traced(S_, mesh, axis, block))(S)


def distributed_cholesky_solve(L, r, mesh: Mesh, axis: str = AXIS,
                               block: int = 8):
    """Solve S x = r given the row-sharded factor L; ``r`` is [n] or
    [n, k] (multi-RHS); returns x replicated with the same shape."""
    D = mesh.shape[axis]
    _check_dims(L.shape[0], D, block)
    squeeze = r.ndim == 1
    if squeeze:
        r = r[:, None]
    r = jax.device_put(r, NamedSharding(mesh, P()))
    f = jax.shard_map(lambda A, b: _solve_local(A, b, block, axis),
                      mesh=mesh, in_specs=(P(axis, None), P()),
                      out_specs=P(), check_vma=False)
    x = jax.jit(f)(L, r)
    return x[:, 0] if squeeze else x


def solve_reduced_direct(problem: rcs.RCSProblem, b: rcs.Blocks,
                         mesh: Mesh, axis: str = AXIS, block: int = 8):
    """Direct TP solve of the reduced system: assemble, pad to the mesh,
    factorise, solve.  Returns (xc [M, 6], xg [G]) like `rcs.pcg`."""
    S, r = assemble_reduced_system(problem, b)
    D = mesh.shape[axis]
    u = S.shape[0]
    step = D * block
    Sp, rp = pad_spd(S, r, -(-u // step) * step)
    L = distributed_cholesky(Sp, mesh, axis, block)
    x = distributed_cholesky_solve(L, rp, mesh, axis, block)[:u]
    M = problem.num_images
    return x[:6 * M].reshape(M, 6), x[6 * M:]


def reduced_cofactor_columns(L, indices, u, mesh: Mesh, axis: str = AXIS,
                             block: int = 8):
    """Selected columns of the reduced block's posterior cofactor S^{-1}
    from the distributed factor: the exact (tolerance-free) counterpart of
    the matrix-free PCG recovery in `parallel/covariance.py`, mirroring the
    reference's REDUCED inversion mode which inverts the retained block on
    the final pass (BundleAdjustment.java:255-298, :65-70).

    ``L``: row-sharded factor of the (possibly padded) system; ``indices``:
    global column indices (< u, the unpadded size); returns [u, k]."""
    n = L.shape[0]
    idx = np.asarray(indices)
    if idx.size and not ((idx >= 0).all() and (idx < u).all()):
        raise ValueError(
            f"cofactor column indices must lie in [0, {u}); got "
            f"min={idx.min()} max={idx.max()} (JAX would silently clamp "
            "out-of-range indices into the padded identity block)")
    E = jnp.zeros((n, idx.shape[0]), L.dtype).at[idx, np.arange(len(idx))
                                                 ].set(1.0)
    return distributed_cholesky_solve(L, E, mesh, axis, block)[:u]
