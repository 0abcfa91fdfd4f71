"""Direct (factored) posterior covariance at scale — feature-major engine.

The reference's REDUCED inversion mode factorises the retained block and
inverts it on the final pass (BundleAdjustment.java:255-298, :65-70,
MathExtension.java:338-366); the point-eliminated mirror image of that at
scale is: the reduced camera+global system S is *small* (u = 6M + G;
~3k at 500 images, ~30k at 5000), so assemble it densely once, factorise it
with dense matmul-heavy kernels, and recover *every* point's 3x3 posterior
block (and any camera/global block) from S^{-1} by block gathers — no
per-block PCG.

    Q_cam       = S^{-1}
    Qpp[p]      = Hpp^{-1}[p] + C_p^T S^{-1} C_p
    C_p         = Hxp[:, p] Hpp^{-1}[p]    (nonzero at p's V image blocks
                                            and the global rows)

Complexity: assembly is sum_p (3 x 6M) panel matmuls (chunked),
factor+inverse is O(u^3) once, then every point block costs a [V6+G]^2
gather + tiny einsums — far cheaper per block than the matrix-free PCG
recovery (`parallel/covariance.py`), which remains the right tool when u
itself is too large to factorise.

All functions take the feature-major `engine.FMProblem`/`FMBlocks`
(uniform point-major layout).  The reduced system here is the *damped*
system only if the caller linearised with damping > 0; covariance wants
damping = 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import engine

# An f32 matmul without a stated precision may run in TF32 on the GPU (about
# three decimal digits): unacceptable for covariance / normal-equation
# products.  All value x value contractions here pin full f32.
_PREC = jax.lax.Precision.HIGHEST


def _i32c(*idx):
    """dynamic_slice wants same-dtype indices (x64-safe int32 pin)."""
    return tuple(jnp.asarray(i, jnp.int32) for i in idx)


def _choose_chunk(P: int, target: int = 4096) -> int:
    """Largest chunk <= target dividing P (P is a multiple of 128 after
    engine.pad_problem; fall back to any divisor for tiny tests)."""
    best = 1
    for c in range(1, min(P, target) + 1):
        if P % c == 0:
            best = c
    return best


def _hpc_rows(b: engine.FMBlocks):
    """Per-observation Hpc = Jp^T P Jc as an [N, 3, 6] array (small-N
    paths only; the large paths keep the 2D row form below)."""
    rows = [[b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e]
             for e in range(6)] for a in range(3)]
    return jnp.stack([jnp.stack(r, axis=1) for r in rows], axis=1)


def _hpc_rows2d(b: engine.FMBlocks):
    """Hpc as 18 feature rows [18, N], row index a*6 + e — the 2D row
    form of the feature-major engine (each row one contiguous array)."""
    return jnp.stack([b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e]
                      for a in range(3) for e in range(6)])


def _hpg_rows2d(p: engine.FMProblem, b: engine.FMBlocks):
    """Per-point Hpg as rows [3*G, P], row index a*G + g."""
    G2 = len(b.Jg) // 2
    return jnp.stack([
        engine._point_sum(p, b.Jp[a] * b.PJg[g] + b.Jp[3 + a] * b.PJg[G2 + g])
        for a in range(3) for g in range(G2)])


def _w_rows2d(b: engine.FMBlocks, hpg_rows, G2):
    """W = Hpp^{-1} Hpg as rows [3*G, P] from the 6 symmetric inverse
    rows (engine._hinv_apply per global column)."""
    rows = []
    for g in range(G2):
        z = engine._hinv_apply(b.Hpp_inv, hpg_rows[0 * G2 + g],
                               hpg_rows[1 * G2 + g], hpg_rows[2 * G2 + g])
        rows.append(z)
    return jnp.stack([rows[g][a] for a in range(3) for g in range(G2)])


def _hpg_points(p: engine.FMProblem, b: engine.FMBlocks):
    """Per-point Hpg [P, 3, G]."""
    G2 = len(b.Jg) // 2
    rows = [[engine._point_sum(p, b.Jp[a] * b.PJg[g]
                               + b.Jp[3 + a] * b.PJg[G2 + g])
             for g in range(G2)] for a in range(3)]
    return jnp.stack([jnp.stack(r, axis=1) for r in rows], axis=1)


def _hinv3(b: engine.FMBlocks):
    """Hpp^{-1} as [P, 3, 3] from the 6 symmetric rows."""
    h = b.Hpp_inv
    return jnp.stack([
        jnp.stack([h[0], h[1], h[2]], axis=1),
        jnp.stack([h[1], h[3], h[4]], axis=1),
        jnp.stack([h[2], h[4], h[5]], axis=1),
    ], axis=1)


#: image count above which the per-image reduction falls back to chunked
#: scatter-adds (below it a one-hot matmul reduction replaces the element
#: scatter; the one-hot operand grows with M).
ONEHOT_M_MAX = 2048


def assemble_reduced_base(p: engine.FMProblem, b: engine.FMBlocks,
                          damping=0.0):
    """Stage 1 of the dense reduced system: per-image Hcc/Hcg blocks and
    the global Sgg — consumes only the Jc/PJc/Jg/PJg/Jp rows (XLA
    dead-code-eliminates the rest of the linearisation), so it can run as
    its own program at the 1M-point scale where the full one-shot
    assembly exceeds device memory.  Returns S0 [u, u] with the camera-camera
    correction still missing (see `assemble_reduced_corrections`)."""
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    K = 6 * M
    dt = b.Jp[0].dtype

    # per-image full blocks, chunked over observations (no [Nip, F]
    # permutation-gather of all feature rows at once).  Dispatch:
    #   M <= ONEHOT_M_MAX  one-hot matmul reduction O^T @ feat (exact: the
    #                      0/1 one-hot is exact in bf16 and the f32 value
    #                      operand rides a 3-way bf16 split; f64 keeps a
    #                      plain HIGHEST dot)
    #   else               per-chunk scatter-add (M-independent)
    iu = np.triu_indices(6)
    F99 = 21 + 6 * G2
    img = p.obs_image.astype(jnp.int32)
    N = img.shape[0]
    use_onehot = M <= ONEHOT_M_MAX
    if use_onehot:
        # bound the [3 cV0, M] one-hot operand to ~200 MB
        lim = max(512, int(2.0e8 / (6 * M)))
        cV0 = _choose_chunk(N, min(65536, lim))
    else:
        cV0 = _choose_chunk(N, 65536)

    def red_body(i, acc):
        o0 = i * cV0

        def sl(r):
            return jax.lax.dynamic_slice(r, (o0,), (cV0,))

        jc = [sl(r) for r in b.Jc]
        pjc = [sl(r) for r in b.PJc]
        pjg = [sl(r) for r in b.PJg]
        rows = [jc[e] * pjc[f] + jc[6 + e] * pjc[6 + f]
                for e, f in zip(*iu)]
        rows += [jc[e] * pjg[g] + jc[6 + e] * pjg[G2 + g]
                 for e in range(6) for g in range(G2)]
        feat = jnp.stack(rows, axis=1)                    # [cV0, F99]
        im = jax.lax.dynamic_slice(img, (o0,), (cV0,))
        if not use_onehot:
            return acc.at[im].add(feat)
        iota_m = jax.lax.broadcasted_iota(jnp.int32, (cV0, M), 1)
        dn0 = (((0,), (0,)), ((), ()))
        if dt == jnp.float32:
            bf = jnp.bfloat16
            O = (im[:, None] == iota_m).astype(bf)
            f1 = feat.astype(bf)
            r1 = feat - f1.astype(dt)
            f2 = r1.astype(bf)
            f3 = (r1 - f2.astype(dt)).astype(bf)
            Ocat = jnp.concatenate([O, O, O], axis=0)
            Fcat = jnp.concatenate([f1, f2, f3], axis=0)
            return acc + jax.lax.dot_general(
                Ocat, Fcat, dn0, preferred_element_type=dt)
        O = (im[:, None] == iota_m).astype(dt)
        return acc + jax.lax.dot_general(O, feat, dn0, precision=_PREC)

    red = jax.lax.fori_loop(0, N // cV0, red_body,
                            jnp.zeros((M, F99), dt))
    Hcc = jnp.zeros((M, 6, 6), dt)
    Hcc = Hcc.at[:, iu[0], iu[1]].set(red[:, :21])
    Hcc = Hcc.at[:, iu[1], iu[0]].set(red[:, :21])
    Hcg = red[:, 21:].reshape(M, 6, G2)

    # extra_c exactly as engine.finish_reduction (damping on the diagonal,
    # fixed-EO unit rows, directly-observed EO weights)
    hdiag = Hcc[:, jnp.arange(6), jnp.arange(6)]
    extra_c = damping * hdiag + (1.0 - p.free_eo)
    if p.de_w is not None:
        extra_c = extra_c + p.de_w * p.free_eo * (1.0 + damping)
    Hcc = Hcc + extra_c[:, :, None] * jnp.eye(6, dtype=dt)

    # global block ---------------------------------------------------------
    JgM = jnp.stack(b.Jg)
    PJgM = jnp.stack(b.PJg)
    T2 = jnp.matmul(JgM, PJgM.T, precision=_PREC)
    Hgg = T2[:G2, :G2] + T2[G2:, G2:] + jnp.diag(b.extra_g)

    # Sgg correction via 2D row matmuls
    hpg_rows = _hpg_rows2d(p, b)      # [3G, P]
    W_rows = _w_rows2d(b, hpg_rows, G2)
    T3 = jnp.matmul(W_rows, hpg_rows.T, precision=_PREC)  # [3G, 3G]
    corr_g = sum(T3[a * G2:(a + 1) * G2, a * G2:(a + 1) * G2]
                 for a in range(3))
    Sgg = Hgg - corr_g

    u = K + G2
    S0 = jnp.zeros((u, u), dt)
    # block-diagonal add via 2D scatter (no [M, 6, M, 6] intermediate)
    i6 = jnp.arange(6)
    bi = jnp.arange(M)[:, None, None] * 6
    S0 = S0.at[bi + i6[None, :, None], bi + i6[None, None, :]].add(Hcc)
    S0 = S0.at[:K, K:].set(Hcg.reshape(K, G2))
    S0 = S0.at[K:, :K].set(Hcg.reshape(K, G2).T)
    S0 = S0.at[K:, K:].set(Sgg)
    return S0


def _mm_split3(A, B):
    """A @ B in 3 native bf16 matmul passes (a1b1 + a1b2 + a2b1): ~2^-16
    relative error, far beyond the ~4e-3 of one bf16 pass.  For the
    O(P*K^2) covariance correction panels at the 1M scale.

    The three passes ride ONE dot over a concatenated contraction axis —
    three separate dots each materialise a [K, K] f32 partial before the
    adds when XLA declines to fuse them."""
    f32 = jnp.float32
    bf = jnp.bfloat16
    a1 = A.astype(bf)
    a2 = (A - a1.astype(f32)).astype(bf)
    b1 = B.astype(bf)
    b2 = (B - b1.astype(f32)).astype(bf)
    A3 = jnp.concatenate([a1, a1, a2], axis=1)
    B3 = jnp.concatenate([b1, b2, b1], axis=0)
    return jnp.dot(A3, B3, preferred_element_type=f32)


def _mm_split3_c0(A, B):
    """`_mm_split3` contracting axis 0 of both operands (A [k, m], B [k, n]
    -> [m, n]): the 3 bf16 passes ride one dot over a concatenated
    contraction axis 0."""
    f32 = jnp.float32
    bf = jnp.bfloat16
    a1 = A.astype(bf)
    a2 = (A - a1.astype(f32)).astype(bf)
    b1 = B.astype(bf)
    b2 = (B - b1.astype(f32)).astype(bf)
    A3 = jnp.concatenate([a1, a1, a2], axis=0)
    B3 = jnp.concatenate([b1, b2, b1], axis=0)
    return jax.lax.dot_general(A3, B3, (((0,), (0,)), ((), ())),
                               preferred_element_type=f32)


def assemble_corrections_outer(p: engine.FMProblem, b: engine.FMBlocks,
                               chunk: int | None = None,
                               split_dots: bool | None = None):
    """Camera-camera / camera-global Schur corrections via per-view
    OUTER-PRODUCT panel fills + one stacked dot per chunk.

    Replaces `assemble_corrections_panel`'s per-chunk scatter fill
    (c*V*18-element scatters) with V broadcasted outer products
    (elementwise, 18*M*c elements per view) building the panels in E-MAJOR
    row order [3, c, 6, M] -> [(a c), (e M)], so the fill needs no
    per-element scatters and no [., 3, M, 6] destination; the accumulated
    (Acc, Acg) are permuted to the camera-major (6m+e) layout ONCE at the
    end.  Same O(P * 3 * K^2) dot flops as the panel form.

    ``split_dots``: None dispatches on dtype (f32 -> `_mm_split3_c0`,
    ~2^-16 relative; f64 -> exact HIGHEST dot)."""
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    V = p.views
    K = 6 * M
    dt = b.Jp[0].dtype
    if split_dots is None:
        split_dots = dt == jnp.float32
    if chunk is None:
        # the Td/Tb slabs are [3, c, 6, M] each (~144*M*c bytes f32)
        target = max(128, int(3.0e8 / (144 * M)))
        chunk = _choose_chunk(p.num_points, min(4096, target))
    hpc2, brow2, W_rows = panel_rows(p, b)
    img = p.obs_image.astype(jnp.int32)
    nchunks = p.num_points // chunk
    cV = chunk * V
    dn0 = (((0,), (0,)), ((), ()))

    def body(i, carry):
        Acc, Acg = carry
        o0 = i * cV
        im = jax.lax.dynamic_slice(img, _i32c(o0), (cV,)).reshape(chunk, V)
        hd = jax.lax.dynamic_slice(
            hpc2, _i32c(0, o0), (18, cV)).reshape(18, chunk, V)
        hb = jax.lax.dynamic_slice(
            brow2, _i32c(0, o0), (18, cV)).reshape(18, chunk, V)
        iota_m = jax.lax.broadcasted_iota(jnp.int32, (chunk, M), 1)
        Td = jnp.zeros((3, chunk, 6, M), dt)
        Tb = jnp.zeros((3, chunk, 6, M), dt)
        for v in range(V):
            O_v = (im[:, v:v + 1] == iota_m).astype(dt)       # [c, M]
            dv = hd[:, :, v].reshape(3, 6, chunk).transpose(0, 2, 1)
            bv = hb[:, :, v].reshape(3, 6, chunk).transpose(0, 2, 1)
            Td = Td + dv[:, :, :, None] * O_v[None, :, None, :]
            Tb = Tb + bv[:, :, :, None] * O_v[None, :, None, :]
        A = Td.reshape(3 * chunk, K)
        Bm = Tb.reshape(3 * chunk, K)
        if split_dots:
            Acc = Acc + _mm_split3_c0(A, Bm)
        else:
            Acc = Acc + jax.lax.dot_general(A, Bm, dn0, precision=_PREC)
        wc = jax.lax.dynamic_slice(
            W_rows, _i32c(0, i * chunk), (3 * G2, chunk))
        wc = wc.reshape(3, G2, chunk).transpose(0, 2, 1).reshape(
            3 * chunk, G2)
        Acg = Acg + jax.lax.dot_general(A, wc, dn0, precision=_PREC)
        return Acc, Acg

    Acc_em, Acg_em = jax.lax.fori_loop(
        0, nchunks, body, (jnp.zeros((K, K), dt), jnp.zeros((K, G2), dt)))
    # e-major (e*M + m) -> camera-major (6m + e), once
    Acc = Acc_em.reshape(6, M, 6, M).transpose(1, 0, 3, 2).reshape(K, K)
    Acg = Acg_em.reshape(6, M, G2).transpose(1, 0, 2).reshape(K, G2)
    return Acc, Acg


def assemble_corrections_panel(p: engine.FMProblem, b: engine.FMBlocks,
                               chunk: int | None = None,
                               split_dots: bool = False):
    """Camera-camera / camera-global Schur corrections via dense
    [3c, K] PANEL products.

    Per point chunk: scatter the per-observation Hpc blocks (and their
    Hpp^{-1}-applied twins — computed as cheap elementwise row ops per
    observation, no depth-3 matmul) into dense [c, 3, M, 6] panels
    (c*V*18 scattered elements each — small), then one matmul
    accumulates Acc += D^T B and a second Acg += D^T Wpg.
    O(P * 3 * K^2) flops — matmul-bound while K = 6M is small, where the
    sparse pair-block path's c*V^2*36-element scatter-adds dominate.
    `assemble_reduced_corrections` (sparse pair blocks, O(P * V^2 * 36)
    flops) has fewer flops when K is large.

    ``split_dots``: run the big D^T B product with `_mm_split3` (3 bf16
    passes, ~2^-16) instead of Precision.HIGHEST (f32-exact), at an error
    far below the statistical meaning of a covariance.  Returns
    (Acc [K,K], Acg [K,G])."""
    G2 = engine._G2(p, b)
    K = 6 * p.num_images
    dt = b.Jp[0].dtype
    if chunk is None:
        # the loop body holds two [chunk*3, K] slabs (D, B) plus the Acc
        # accumulator; bound the slabs to ~300 MB
        target = max(128, int(3.0e8 / (24 * K)))
        chunk = _choose_chunk(p.num_points, min(4096, target))
    hpc2, brow2, W_rows = panel_rows(p, b)
    return corrections_group(
        p, hpc2, brow2, W_rows, G2,
        jnp.zeros((K, K), dt), jnp.zeros((K, G2), dt),
        jnp.int32(0), chunk, p.num_points // chunk, split_dots=split_dots)


def panel_rows(p: engine.FMProblem, b: engine.FMBlocks):
    """The three row arrays the panel corrections and the dense recovery
    consume: (hpc2 [18, N], brow2 [18, N] — the Hpp^{-1}-applied twin,
    W_rows [3G, P])."""
    b = engine.materialize_global_rows(p, b)
    G2 = len(b.Jg) // 2
    hpc2 = _hpc_rows2d(b)
    hinv_obs = [engine._point_expand(p, h) for h in b.Hpp_inv]
    bro = []
    for e in range(6):
        z = engine._hinv_apply(hinv_obs, hpc2[0 * 6 + e], hpc2[1 * 6 + e],
                               hpc2[2 * 6 + e])
        bro.append(z)
    brow2 = jnp.stack([bro[e][a] for a in range(3) for e in range(6)])
    hpg_rows = _hpg_rows2d(p, b)
    W_rows = _w_rows2d(b, hpg_rows, G2)
    return hpc2, brow2, W_rows


def corrections_group(p: engine.FMProblem, hpc2, brow2, W_rows, G2: int,
                      Acc, Acg, i0, chunk: int, ngroup: int,
                      split_dots: bool = True):
    """``ngroup`` panel chunks of the corrections accumulation, starting at
    chunk index ``i0`` (traced — ONE compiled program serves every group).
    Donate (Acc, Acg) when jitting.  See `assemble_corrections_panel` for
    the panel formulation."""
    M = p.num_images
    V = p.views
    K = 6 * M
    dt = hpc2.dtype
    img = p.obs_image.astype(jnp.int32)
    cV = chunk * V
    f32 = jnp.float32
    bf = jnp.bfloat16
    iota_m = jax.lax.broadcasted_iota(jnp.int32, (1, 1, M), 2)

    def body(j, carry):
        Acc, Acg = carry
        i = i0 + j
        o0 = i * cV
        im = jax.lax.dynamic_slice(img, _i32c(o0), (cV,)).reshape(chunk, V)
        # exact-in-bf16 one-hot over images, replicated 3x along the
        # contracted view axis for the split-operand exact-f32 fill
        O = (im[:, :, None] == iota_m).astype(bf)        # [c, V, M]
        Ocat = jnp.concatenate([O, O, O], axis=1)        # [c, 3V, M]
        dn = (((1,), (1,)), ((0,), (0,)))

        def panel(rows2):
            if dt == jnp.float64 or M <= 1024:
                # scatter fill: exact, and fine while the [c, 3, M, 6]
                # destination stays small; at small M the one-hot batched
                # fill's tiny [18, 3V] x [3V, M] matmuls waste the
                # matrix unit
                hpc = jax.lax.dynamic_slice(
                    rows2, _i32c(0, o0), (18, cV)).T.reshape(cV, 3, 6)
                pl = jnp.arange(cV, dtype=jnp.int32) // jnp.int32(V)
                D = jnp.zeros((chunk, 3, M, 6), dt).at[
                    pl, :, im.reshape(-1), :].add(hpc)
                return D.reshape(chunk * 3, K)
            # one-hot batched matmul fill instead of the [c, 3, M, 6]
            # scatter destination at large M; the value operand is split
            # into 3 bf16 chunks so the fill stays f32-exact
            h = jax.lax.dynamic_slice(
                rows2, _i32c(0, o0), (18, cV)).T.reshape(chunk, V, 18)
            h1 = h.astype(bf)
            r = h - h1.astype(f32)
            h2 = r.astype(bf)
            h3 = (r - h2.astype(f32)).astype(bf)
            Hcat = jnp.concatenate([h1, h2, h3], axis=1)  # [c, 3V, 18]
            D = jax.lax.dot_general(Hcat, Ocat, dn,
                                    preferred_element_type=f32)
            # [c, 18, M] (row index a*6 + e) -> [c*3, 6M]
            return D.reshape(chunk, 3, 6, M).transpose(
                0, 1, 3, 2).reshape(chunk * 3, K)

        Df = panel(hpc2)
        Bf = panel(brow2)
        if split_dots:
            Acc = Acc + _mm_split3(Df.T, Bf)
        else:
            Acc = Acc + jnp.matmul(Df.T, Bf, precision=_PREC)
        wpg = jax.lax.dynamic_slice(
            W_rows, _i32c(0, i * chunk), (3 * G2, chunk))
        wpg = wpg.reshape(3, G2, chunk).transpose(2, 0, 1)
        Acg = Acg + jnp.matmul(Df.T, wpg.reshape(chunk * 3, G2),
                               precision=_PREC)
        return Acc, Acg

    return jax.lax.fori_loop(0, ngroup, body, (Acc, Acg))


def assemble_reduced_corrections(p: engine.FMProblem, b: engine.FMBlocks,
                                 S0=None, chunk: int | None = None):
    """Stage 2: the camera-camera / camera-global Schur corrections as
    chunked SPARSE pair blocks.

    Each point touches only its V image blocks, so its correction is a
    [V6, V6] block outer product — P * (3 * (6V)^2) useful flops (~6e10 at
    1M pts), where the dense [3c, K] panel formulation spends
    P * 3 * K^2 (~3e15 at K = 30k).  The pair blocks are scatter-added
    into the [K, K] accumulator once per chunk.

    With ``S0`` given returns the corrected S (one-shot path); with
    ``S0=None`` returns (Acc [K, K], Acg [K, G]) so the subtraction runs
    as its own donated program.  Consumes only the Jp/PJc/PJg rows +
    Hpp_inv."""
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    P_, V = p.num_points, p.views
    K = 6 * M
    dt = b.Jp[0].dtype
    if chunk is None:
        # [c, V, V, 6, 6] pair tensor ~ c * V^2 * 144 bytes; keep ~300 MB
        target = max(64, int(3.0e8 / (V * V * 144)))
        chunk = _choose_chunk(P_, min(4096, target))

    # all large per-observation/per-point quantities in the 2D row form
    hpc2 = _hpc_rows2d(b)             # [18, N]
    hpg_rows = _hpg_rows2d(p, b)      # [3G, P]
    W_rows = _w_rows2d(b, hpg_rows, G2)
    hinv_rows = jnp.stack(list(b.Hpp_inv))   # [6, P]
    img = p.obs_image.astype(jnp.int32)
    nchunks = P_ // chunk
    cV = chunk * V
    i6 = jnp.arange(6)

    def body(i, carry):
        Acc, Acg = carry
        o0 = i * cV
        hpc_v = jax.lax.dynamic_slice(
            hpc2, (0, o0), (18, cV)).T.reshape(chunk, V, 3, 6)
        im = jax.lax.dynamic_slice(img, (o0,), (cV,)).reshape(chunk, V)
        h = jax.lax.dynamic_slice(hinv_rows, _i32c(0, i * chunk),
                                  (6, chunk))
        hin = jnp.stack([
            jnp.stack([h[0], h[1], h[2]], axis=1),
            jnp.stack([h[1], h[3], h[4]], axis=1),
            jnp.stack([h[2], h[4], h[5]], axis=1),
        ], axis=1)                                        # [c, 3, 3]
        Bv = jnp.einsum("cab,cvbe->cvae", hin, hpc_v, precision=_PREC)
        pair = jnp.einsum("cvae,cwaf->cvwef", hpc_v, Bv,
                          precision=_PREC)                # [c, V, V, 6, 6]
        I = (6 * im)[:, :, None, None, None] + i6[None, None, None, :, None]
        J = (6 * im)[:, None, :, None, None] + i6[None, None, None, None, :]
        Acc = Acc.at[jnp.broadcast_to(I, pair.shape),
                     jnp.broadcast_to(J, pair.shape)].add(pair)
        wc = jax.lax.dynamic_slice(
            W_rows, _i32c(0, i * chunk), (3 * G2, chunk))
        wc = wc.reshape(3, G2, chunk).transpose(2, 0, 1)  # [c, 3, G]
        pg = jnp.einsum("cvae,cag->cveg", hpc_v, wc,
                        precision=_PREC)                  # [c, V, 6, G]
        Ig = (6 * im)[:, :, None] + i6[None, None, :]     # [c, V, 6]
        Acg = Acg.at[Ig.reshape(-1)].add(pg.reshape(-1, G2))
        return Acc, Acg

    Acc, Acg = jax.lax.fori_loop(
        0, nchunks, body, (jnp.zeros((K, K), dt), jnp.zeros((K, G2), dt)))

    if S0 is None:
        return Acc, Acg
    return apply_corrections(S0, Acc, Acg)


def apply_corrections(S0, Acc, Acg):
    """S = S0 - [[Acc, Acg], [Acg^T, 0]] (donate S0 and Acc when jitting
    standalone)."""
    K = Acc.shape[0]
    S = S0.at[:K, :K].add(-Acc)
    S = S.at[:K, K:].add(-Acg)
    S = S.at[K:, :K].add(-Acg.T)
    return S


#: flops bound for the panel-form corrections (6*P*K^2); below it the
#: matmul panel path is preferred to the sparse pair-block scatters
PANEL_FLOPS_MAX = 3e13


def assemble_reduced_dense(p: engine.FMProblem, b: engine.FMBlocks,
                           damping=0.0, chunk: int | None = None,
                           panel: bool | None = None):
    """Dense reduced (Schur) system S [u, u], u = 6M + G, camera-major rows
    (image m, component a) -> row 6m + a, globals last.

    Exact for arbitrary visibility (duplicate (point, image) pairs
    included).  The camera-camera correction dispatches on ``panel``
    (auto: flops bound PANEL_FLOPS_MAX): dense matmul panel products
    (`assemble_corrections_panel`, small K) or sparse pair blocks
    (`assemble_reduced_corrections`, large K).  One-shot form; at memory-
    bound scale run `assemble_reduced_base` and
    `assemble_reduced_corrections` as separate programs (each
    dead-code-eliminates the linearisation rows it does not read).
    """
    S0 = assemble_reduced_base(p, b, damping)
    if panel is None:
        K = 6 * p.num_images
        panel = 6.0 * p.num_points * K * K < PANEL_FLOPS_MAX
    if panel:
        Acc, Acg = assemble_corrections_outer(p, b, chunk=chunk)
        return apply_corrections(S0, Acc, Acg)
    return assemble_reduced_corrections(p, b, S0, chunk=chunk)


def _blocked_spd_solve_panel(L, E, bs: int):
    """X with L L^T X = E by BLOCKED forward+backward substitution.

    ``L`` [u_pad, u_pad] lower (u_pad a multiple of ``bs``), ``E``
    [u_pad, pc].  Explicit [bs, bs] x [bs, pc] tiles keep every temp a
    few hundred MB, where one monolithic `triangular_solve` at u = 30k
    may ask for many u x pc temporaries."""
    u_pad = L.shape[0]
    nbb = u_pad // bs

    def blk(i, j):
        return jax.lax.dynamic_slice(L, _i32c(i * bs, j * bs), (bs, bs))

    def row(i, X):
        return jax.lax.dynamic_slice(
            X, _i32c(i * bs, 0), (bs, X.shape[1]))

    # forward: L Y = E
    Y = jnp.zeros_like(E)
    for i in range(nbb):
        rhs = row(i, E)
        for j in range(i):
            rhs = rhs - jnp.matmul(blk(i, j), row(j, Y), precision=_PREC)
        yi = jax.lax.linalg.triangular_solve(
            blk(i, i), rhs, left_side=True, lower=True)
        Y = jax.lax.dynamic_update_slice(Y, yi, _i32c(i * bs, 0))

    # backward: L^T X = Y
    X = jnp.zeros_like(E)
    dn_t = (((0,), (0,)), ((), ()))  # contract first dims: L_ji^T X_j
    for i in range(nbb - 1, -1, -1):
        rhs = row(i, Y)
        for j in range(i + 1, nbb):
            rhs = rhs - jax.lax.dot_general(
                blk(j, i), row(j, X), dn_t, precision=_PREC)
        xi = jax.lax.linalg.triangular_solve(
            blk(i, i), rhs, left_side=True, lower=True, transpose_a=True)
        X = jax.lax.dynamic_update_slice(X, xi, _i32c(i * bs, 0))
    return X


def reduced_inverse(S, panel: int | None = None, block: int = 2048):
    """S^{-1} via Cholesky (SPD; the reduced system of a datum-fixed or
    directly-observed network is SPD — survey F12 REDUCED semantics).

    For u beyond ``panel`` the identity right-hand side is streamed in
    column panels solved by BLOCKED substitution
    (`_blocked_spd_solve_panel`): peak extra memory is L + Q + one
    [u, panel] slab with [block, panel] temps, where the one-shot
    formulation holds 4 u x u temporaries."""
    u = S.shape[0]
    if panel is None:
        panel = u if u <= 4096 else 1024
    if panel >= u:
        L = jnp.linalg.cholesky(S)
        eye = jnp.eye(u, dtype=S.dtype)
        Y = jax.lax.linalg.triangular_solve(L, eye, left_side=True,
                                            lower=True)
        return jax.lax.linalg.triangular_solve(
            L, Y, left_side=True, lower=True, transpose_a=True)
    u_pad = -(-u // block) * block
    if u_pad > u:
        # pad S with an identity tail BEFORE the factorization (padding L
        # afterwards holds two u_pad^2 copies alive — 8.6 GB at u = 30k)
        Sp = jnp.zeros((u_pad, u_pad), S.dtype)
        Sp = Sp.at[:u, :u].set(S)
        Sp = Sp.at[jnp.arange(u, u_pad), jnp.arange(u, u_pad)].set(1.0)
        S = Sp
    L = jnp.linalg.cholesky(S)
    rows = jax.lax.broadcasted_iota(jnp.int32, (u_pad, panel), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (u_pad, panel), 1)

    def body(i, Q):
        E = (rows == cols + i * panel).astype(S.dtype)
        Qp = _blocked_spd_solve_panel(L, E, block)
        return jax.lax.dynamic_update_slice(
            Q, Qp[:u], _i32c(0, i * panel))

    npan = u_pad // panel
    Q = jax.lax.fori_loop(0, npan, body, jnp.zeros((u, u_pad), S.dtype))
    return Q[:, :u]


#: reduced-system size above which the dense-panel recovery's
#: O(2 u^2 3P) matmul flops exceed the row-gather path's read cost —
#: below it the panel form is gather-free and matmul-bound
DENSE_RECOVERY_U_MAX = 8192


def _emajor_perm(M: int, G2: int) -> np.ndarray:
    """src indices permuting the camera-major reduced layout (6m+e,
    globals last) into E-MAJOR (e*M + m, globals last)."""
    idx = np.arange(6 * M)
    return np.concatenate([6 * (idx % M) + idx // M,
                           6 * M + np.arange(G2)])


def _pcd_dense_all(p, brow2, w_rows, hinv_rows, Qred, G2: int,
                   chunk: int):
    """All-points recovery as dense matmul panels, entirely in ROW FORM.

    Per chunk and per point-axis component b: build the coupling panel
    D_b [u, c] (e-major camera rows) by V broadcasted outer products of
    the Hpp^{-1}-applied rows ``brow2`` (= E in row form, index b*6+e)
    with the per-view one-hot — no gathers, no scatters, no size-3 minor
    dimension; the global rows are ``w_rows`` slices (= C_p's global
    block, index b*G+g).  One matmul Y_b = Qem @ D_b each, and the sym
    rows fall out of contiguous axis-0 reductions sum_u D_b * Y_d.
    O(2 u^2 3P) flops, zero element gathers.  Returns the 6 sym rows
    [6, P]."""
    V = p.views
    M = p.num_images
    K = 6 * M
    u = Qred.shape[0]
    P_ = p.num_points
    dt = Qred.dtype
    bf = jnp.bfloat16
    img = p.obs_image.astype(jnp.int32)
    perm = jnp.asarray(_emajor_perm(M, G2))
    Qem = Qred[perm][:, perm]
    split = dt == jnp.float32
    if split:
        q1 = Qem.astype(bf)
        q2 = (Qem - q1.astype(dt)).astype(bf)
        # loop-invariant split operand: 3 bf16 passes ride one dot
        Qcat = jnp.concatenate([q1, q1, q2], axis=1)      # [u, 3u]
    nch = P_ // chunk
    cV = chunk * V

    def body(i, acc):
        c0 = i * chunk
        o0 = c0 * V
        im = jax.lax.dynamic_slice(img, _i32c(o0), (cV,)).reshape(
            chunk, V)
        eb = jax.lax.dynamic_slice(
            brow2, _i32c(0, o0), (18, cV)).reshape(18, chunk, V)
        iota_mc = jax.lax.broadcasted_iota(jnp.int32, (M, chunk), 0)
        Dem = [jnp.zeros((6, M, chunk), dt) for _ in range(3)]
        for v in range(V):
            O_vT = (im[:, v][None, :] == iota_mc).astype(dt)  # [M, c]
            for bq in range(3):
                Ev = eb[bq * 6:(bq + 1) * 6, :, v]            # [6, c]
                Dem[bq] = Dem[bq] + Ev[:, None, :] * O_vT[None, :, :]
        w = jax.lax.dynamic_slice(w_rows, _i32c(0, c0), (3 * G2, chunk))
        h6 = jax.lax.dynamic_slice(hinv_rows, _i32c(0, c0), (6, chunk))
        Ds, Ys = [], []
        for bq in range(3):
            Db = jnp.concatenate(
                [Dem[bq].reshape(K, chunk),
                 w[bq * G2:(bq + 1) * G2]])                   # [u, c]
            Ds.append(Db)
            if split:
                b1 = Db.astype(bf)
                r1 = Db - b1.astype(dt)
                b2 = r1.astype(bf)
                B3 = jnp.concatenate([b1, b2, b1], axis=0)
                Ys.append(jnp.dot(Qcat, B3, preferred_element_type=dt))
            else:
                Ys.append(jnp.matmul(Qem, Db, precision=_PREC))
        rows = jnp.stack([
            h6[k] + jnp.sum(Ds[bq] * Ys[dq], axis=0)
            for k, (bq, dq) in enumerate(
                ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))])
        return jax.lax.dynamic_update_slice(acc, rows, _i32c(0, c0))

    return jax.lax.fori_loop(0, nch, body, jnp.zeros((6, P_), dt))


def point_covariance_dense(p: engine.FMProblem, b: engine.FMBlocks, Qred,
                           point_ids=None, chunk: int | None = None):
    """3x3 posterior cofactor blocks Qpp[p] = Hpp^{-1} + C_p^T S^{-1} C_p
    for the selected points (all points when ``point_ids`` is None), given
    the dense reduced-cofactor Qred = S^{-1} from `reduced_inverse`.

    All-points with u <= `DENSE_RECOVERY_U_MAX`: gather-free dense matmul
    panels (`_pcd_dense_all`).  Otherwise: gathers the rows of Qred that
    p's coupling touches and contracts with the compact C_p —
    O(k (6V+G)^2) total.  Returns [k, 3, 3]."""
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    V = p.views
    K = 6 * M
    dt = b.Jp[0].dtype

    # large per-observation/per-point quantities kept in the 2D row form;
    # chunks gathered from the rows are transposed into small block
    # tensors
    hpc2 = _hpc_rows2d(b)                                 # [18, N]
    hinv_rows = jnp.stack(list(b.Hpp_inv))                # [6, P]
    hpg_rows = _hpg_rows2d(p, b)                          # [3G, P]
    img = p.obs_image.astype(jnp.int32).reshape(p.num_points, V)

    u_red = Qred.shape[0]
    if point_ids is None and chunk is None \
            and u_red <= DENSE_RECOVERY_U_MAX:
        # per-b [u, c] panel+product slabs bounded to ~45 MB each; the
        # applied rows brow2/W_rows double as E / C_p in row form
        cd = max(64, int(1.1e7 / max(u_red, 1)))
        cd = _choose_chunk(p.num_points, min(4096, cd))
        _, brow2, W_rows = panel_rows(p, b)
        rows6 = _pcd_dense_all(p, brow2, W_rows, hinv_rows, Qred, G2, cd)
        return jnp.stack([
            jnp.stack([rows6[0], rows6[1], rows6[2]], axis=1),
            jnp.stack([rows6[1], rows6[3], rows6[4]], axis=1),
            jnp.stack([rows6[2], rows6[4], rows6[5]], axis=1),
        ], axis=1)

    Qcg = Qred[:K, K:].reshape(M, 6, G2)
    Qgg = Qred[K:, K:]

    if point_ids is None:
        point_ids = jnp.arange(p.num_points)
    point_ids = jnp.asarray(point_ids)
    k = point_ids.shape[0]
    if chunk is None:
        chunk = recovery_chunk(k, p.views, Qred.shape[0])

    def one_chunk(ids):
        rows = _pcd_chunk(p, hpc2, hinv_rows, hpg_rows, Qred, Qcg, Qgg,
                          G2, ids)
        return jnp.stack([
            jnp.stack([rows[0], rows[1], rows[2]], axis=1),
            jnp.stack([rows[1], rows[3], rows[4]], axis=1),
            jnp.stack([rows[2], rows[4], rows[5]], axis=1),
        ], axis=1)

    nch = k // chunk
    out = jax.lax.map(
        lambda i: one_chunk(jax.lax.dynamic_slice(point_ids, (i * chunk,),
                                                  (chunk,))),
        jnp.arange(nch))
    out = out.reshape(nch * chunk, 3, 3)
    if nch * chunk < k:  # remainder (point_ids not divisible by chunk)
        out = jnp.concatenate([out, one_chunk(point_ids[nch * chunk:])])
    return out


def recovery_rows(p: engine.FMProblem, b: engine.FMBlocks):
    """(hpc2 [18, N], hinv_rows [6, P], hpg_rows [3G, P]) for
    `point_cov_group` — run as its own program at the 1M scale and feed
    the outputs to the group dispatches as ARGUMENTS."""
    b = engine.materialize_global_rows(p, b)
    return (_hpc_rows2d(b), jnp.stack(list(b.Hpp_inv)),
            _hpg_rows2d(p, b))


def _pcd_chunk(p, hpc2, hinv_rows, hpg_rows, Qred, Qcg, Qgg, G2, ids):
    """Core of the dense point-block recovery for one id chunk; returns
    the 6 sym rows [6, c] (00,01,02,11,12,22).

    Gather strategy: instead of the [c, V6, V6] element gather from Qred
    (c*V6^2 random picks), ROW-gather p's V6 coupled rows (the
    embedding-lookup pattern), contract with E2 FIRST (Y = E2^T R — the
    row panel is still u wide), and only then pick the c*3*V6 needed
    columns — 24x fewer element gathers, and the global cross term falls
    out of Y's global columns for free."""
    V = p.views
    img = p.obs_image.astype(jnp.int32).reshape(p.num_points, V)
    i6 = jnp.arange(6)
    iV = jnp.arange(V)
    c = ids.shape[0]
    V6 = 6 * V
    K = Qred.shape[0] - G2
    h = hinv_rows[:, ids]                             # [6, c]
    hin = jnp.stack([
        jnp.stack([h[0], h[1], h[2]], axis=1),
        jnp.stack([h[1], h[3], h[4]], axis=1),
        jnp.stack([h[2], h[4], h[5]], axis=1),
    ], axis=1)                                        # [c, 3, 3]
    obs = (ids[:, None] * V + iV[None, :]).reshape(-1)
    hpc_v = hpc2[:, obs].T.reshape(c, V, 3, 6)
    hpg_c = hpg_rows[:, ids].reshape(3, G2, c).transpose(2, 0, 1)
    # E rows (v, e) of C_p's camera block: [c, V6, 3]
    E2 = jnp.einsum("cvae,cab->cveb", hpc_v, hin,
                    precision=_PREC).reshape(c, V6, 3)
    Cg = jnp.einsum("cag,cab->cgb", hpg_c, hin, precision=_PREC)
    im = img[ids]                                     # [c, V]
    I2 = ((6 * im)[:, :, None] + i6[None, None, :]).reshape(c, V6)
    R = Qred[I2.reshape(-1)].reshape(c, V6, -1)       # [c, V6, u] rows
    Y = jnp.einsum("cub,cux->cbx", E2, R, precision=_PREC)  # [c, 3, u]
    # camera part: pick p's own V6 columns of Y
    t = jnp.take_along_axis(
        Y[:, :, :K], jnp.broadcast_to(I2[:, None, :], (c, 3, V6)), axis=2)
    corr = jnp.einsum("cbw,cwd->cbd", t, E2, precision=_PREC)
    # global cross term straight from Y's global columns
    cross = jnp.einsum("cbg,cgd->cbd", Y[:, :, K:], Cg, precision=_PREC)
    corr = corr + cross + cross.transpose(0, 2, 1)
    corr = corr + jnp.einsum("cgb,gh,chd->cbd", Cg, Qgg, Cg,
                             precision=_PREC)
    Qblk = hin + corr
    return jnp.stack([Qblk[:, 0, 0], Qblk[:, 0, 1], Qblk[:, 0, 2],
                      Qblk[:, 1, 1], Qblk[:, 1, 2], Qblk[:, 2, 2]])


def recovery_chunk(k: int, V: int, u: int, target_bytes: float = 4.0e8,
                   cap: int = 2048) -> int:
    """Recovery chunk bounded by the [c, 6V, u] row panel (the dominant
    per-chunk buffer of `_pcd_chunk`)."""
    c = max(16, int(target_bytes / (6 * V * u * 4)))
    return _choose_chunk(k, min(cap, c))


def point_cov_group(p: engine.FMProblem, hpc2, hinv_rows, hpg_rows, Qred,
                    G2: int, i0, chunk: int, ngroup: int):
    """``ngroup`` recovery chunks starting at chunk index ``i0`` (traced —
    one compiled program serves every group); returns the sym rows
    [6, ngroup*chunk].  The multi-dispatch form of the all-points
    recovery for the staged 1M pipeline: short dispatches, and the output
    stays in row form."""
    M = p.num_images
    K = 6 * M
    Qcg = Qred[:K, K:].reshape(M, 6, G2)
    Qgg = Qred[K:, K:]

    def body(j, acc):
        # ids past P are clamped (their output columns are duplicates the
        # caller slices off) — group sizes need not divide the chunk count
        ids = jnp.minimum((i0 + j) * chunk + jnp.arange(chunk),
                          p.num_points - 1)
        rows = _pcd_chunk(p, hpc2, hinv_rows, hpg_rows, Qred, Qcg, Qgg,
                          G2, ids)
        return jax.lax.dynamic_update_slice(acc, rows,
                                            _i32c(0, j * chunk))

    return jax.lax.fori_loop(
        0, ngroup, body,
        jnp.zeros((6, ngroup * chunk), Qred.dtype))


def camera_covariance_dense(Qred, image_ids):
    """6x6 posterior cofactor blocks of selected images' EO straight from
    the dense reduced cofactor (rows/cols 6m..6m+5 of S^{-1})."""
    ids = jnp.asarray(image_ids)
    M6 = Qred.shape[0]
    Qcc = Qred  # full; gather blocks
    idx = (ids[:, None] * 6 + jnp.arange(6)[None, :]).reshape(-1)
    sub = Qcc[idx][:, idx].reshape(ids.shape[0], 6, ids.shape[0], 6)
    return sub[jnp.arange(ids.shape[0]), :, jnp.arange(ids.shape[0]), :]


def point_pair_covariance_dense(p: engine.FMProblem, b: engine.FMBlocks,
                                Qred, pairs):
    """Cross-point 3x3 cofactor blocks Q[p, q] = C_p^T S^{-1} C_q for the
    given (p, q) pairs — the populated off-diagonal dispersion structure
    (README.md:11-25) from the dense factorised path.  Returns [k, 3, 3]."""
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    V = p.views
    K = 6 * M

    HpcM = _hpc_rows(b).reshape(p.num_points, V, 3, 6)
    Hinv = _hinv3(b)
    HpgP = _hpg_points(p, b)
    img = p.obs_image.astype(jnp.int32).reshape(p.num_points, V)

    Qcg = Qred[:K, K:].reshape(M, 6, G2)
    Qgg = Qred[K:, K:]

    pairs = np.asarray(pairs)
    ip = jnp.asarray(pairs[:, 0])
    iq = jnp.asarray(pairs[:, 1])

    def side(ids):
        hin = Hinv[ids]
        E = jnp.einsum("cvae,cab->cveb", HpcM[ids], hin, precision=_PREC)
        Cg = jnp.einsum("cag,cab->cgb", HpgP[ids], hin, precision=_PREC)
        return E, Cg, img[ids]

    Ep, Cgp, imp = side(ip)
    Eq, Cgq, imq = side(iq)
    i6 = jnp.arange(6)
    I = (6 * imp)[:, :, None, None, None] + i6[None, None, None, :, None]
    J = (6 * imq)[:, None, :, None, None] + i6[None, None, None, None, :]
    Qb = Qred[I, J]                                       # [c, V, V, 6, 6]
    out = jnp.einsum("cveb,cvwef,cwfd->cbd", Ep, Qb, Eq, precision=_PREC)
    out = out + jnp.einsum("cveb,cveg,cgd->cbd", Ep, Qcg[imp], Cgq, precision=_PREC)
    out = out + jnp.einsum("cgb,cwfg,cwfd->cbd", Cgp, Qcg[imq], Eq, precision=_PREC)
    out = out + jnp.einsum("cgb,gh,chd->cbd", Cgp, Qgg, Cgq, precision=_PREC)
    return out
