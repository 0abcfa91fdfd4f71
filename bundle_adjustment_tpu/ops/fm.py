"""Feature-major forward model: collinearity + distortion rows as [N] lanes.

Batched per-observation blocks shaped [N, 2, k] keep tiny minor dimensions
(2 and k) that fit vector hardware badly.  This module evaluates the same
closed forms as `ops/collinearity.py` / `ops/analytic.py` (survey E1,
E6-E10; `derivation/PartialDerivativeFactory.java:58-195` and the
distortion factories) with every per-observation scalar held as a **row of
length N** (one contiguous array), producing the Jacobian as a list of [N]
feature rows instead of an [N, 2, 12+K] block tensor.

The scalar/vmap implementations remain the parity oracle;
`tests/test_engine_fm.py` pins this path against them.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..models.distortion import DistortionSpec, DistortionType
from .analytic import supports_spec  # noqa: F401  (same support surface)
from .distortion import zernike_contribution


class RotationRows(NamedTuple):
    r11: jnp.ndarray
    r12: jnp.ndarray
    r13: jnp.ndarray
    r21: jnp.ndarray
    r22: jnp.ndarray
    r23: jnp.ndarray
    r31: jnp.ndarray
    r32: jnp.ndarray
    r33: jnp.ndarray


def rotation_rows(omega, phi, kappa) -> RotationRows:
    """R(omega, phi, kappa) entries as separate [N] rows
    (ExteriorOrientation.java:52-85 / rotation.rotation_wpk)."""
    co, so = jnp.cos(omega), jnp.sin(omega)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    ck, sk = jnp.cos(kappa), jnp.sin(kappa)
    return RotationRows(
        r11=cp * ck, r12=-cp * sk, r13=sp,
        r21=co * sk + so * sp * ck, r22=co * ck - so * sp * sk, r23=-so * cp,
        r31=so * sk - co * sp * ck, r32=so * ck + co * sp * sk, r33=co * cp,
    )


class ProjectionRows(NamedTuple):
    xs: jnp.ndarray
    ys: jnp.ndarray
    N: jnp.ndarray
    kx: jnp.ndarray
    ky: jnp.ndarray
    R: RotationRows
    dX: jnp.ndarray
    dY: jnp.ndarray
    dZ: jnp.ndarray


def project_rows(X, Y, Z, c, X0, Y0, Z0, omega, phi, kappa) \
        -> ProjectionRows:
    """xs = -c kx / N etc. (PartialDerivativeFactory.java:141-149), all
    inputs/outputs [N] rows."""
    R = rotation_rows(omega, phi, kappa)
    dX, dY, dZ = X - X0, Y - Y0, Z - Z0
    kx = R.r11 * dX + R.r21 * dY + R.r31 * dZ
    ky = R.r12 * dX + R.r22 * dY + R.r32 * dZ
    Ndn = R.r13 * dX + R.r23 * dY + R.r33 * dZ
    xs = -c * kx / Ndn
    ys = -c * ky / Ndn
    return ProjectionRows(xs=xs, ys=ys, N=Ndn, kx=kx, ky=ky, R=R,
                          dX=dX, dY=dY, dZ=dZ)


def jacobian_rows(X, Y, Z, x0, y0, c, X0, Y0, Z0, omega, phi, kappa,
                  coeffs, spec: DistortionSpec, r0):
    """Full analytic A-rows and misclosure inputs, feature-major.

    coeffs: list of K [N] rows (gathered per observation).
    Returns (rows_x, rows_y, pred_x, pred_y): rows_* are lists of 12+K [N]
    rows ordered [X Y Z x0 y0 c X0 Y0 Z0 omega phi kappa, coeffs...] —
    the same layout as ops/analytic.analytic_image_jacobian_and_residual.
    """
    p = project_rows(X, Y, Z, c, X0, Y0, Z0, omega, phi, kappa)
    xs, ys, Ndn, R = p.xs, p.ys, p.N, p.R
    ck, sk = jnp.cos(kappa), jnp.sin(kappa)
    zero = jnp.zeros_like(Ndn)
    one = jnp.ones_like(Ndn)

    # collinearity partials (PartialDerivativeFactory.java:155-189)
    par_xs_X = -(R.r13 * xs + c * R.r11) / Ndn
    par_xs_Y = -(R.r23 * xs + c * R.r21) / Ndn
    par_xs_Z = -(R.r33 * xs + c * R.r31) / Ndn
    par_xs_c = -p.kx / Ndn
    par_xs_omega = (xs * (R.r33 * p.dY - R.r23 * p.dZ)
                    + c * (R.r31 * p.dY - R.r21 * p.dZ)) / Ndn
    par_xs_phi = (xs * (p.ky * sk - p.kx * ck) + c * Ndn * ck) / Ndn
    par_xs_kappa = ys

    par_ys_X = -(R.r13 * ys + c * R.r12) / Ndn
    par_ys_Y = -(R.r23 * ys + c * R.r22) / Ndn
    par_ys_Z = -(R.r33 * ys + c * R.r32) / Ndn
    par_ys_c = -p.ky / Ndn
    par_ys_omega = (ys * (R.r33 * p.dY - R.r23 * p.dZ)
                    + c * (R.r32 * p.dY - R.r22 * p.dZ)) / Ndn
    par_ys_phi = (ys * (p.ky * sk - p.kx * ck) - c * Ndn * sk) / Ndn
    par_ys_kappa = -xs

    cp_xs = [par_xs_X, par_xs_Y, par_xs_Z, one, zero, par_xs_c,
             -par_xs_X, -par_xs_Y, -par_xs_Z,
             par_xs_omega, par_xs_phi, par_xs_kappa]
    cp_ys = [par_ys_X, par_ys_Y, par_ys_Z, zero, one, par_ys_c,
             -par_ys_X, -par_ys_Y, -par_ys_Z,
             par_ys_omega, par_ys_phi, par_ys_kappa]
    # chain-rule carriers exclude the direct x0/y0 identity entries
    dxs = list(cp_xs)
    dys = list(cp_ys)
    dxs[3] = dxs[4] = zero
    dys[3] = dys[4] = zero

    # denominator partials for the distance model
    # (RadialDistanceDistortionModelFactory.java:83-95)
    dN = [R.r13, R.r23, R.r33, zero, zero, zero, -R.r13, -R.r23, -R.r33,
          -R.r33 * p.dY + R.r23 * p.dZ, p.kx * ck - p.ky * sk, zero]

    r2 = xs * xs + ys * ys
    r02 = r0 * r0
    xxs2 = 2.0 * xs * xs
    yys2 = 2.0 * ys * ys
    xys2 = 2.0 * xs * ys

    deltaX = zero
    deltaY = zero
    dX_dxs = zero
    dX_dys = zero
    dY_dxs = zero
    dY_dys = zero
    dX_dN = zero
    dY_dN = zero
    coeff_rows_x = []
    coeff_rows_y = []

    zc = zernike_contribution(xs, ys, coeffs, spec, r0)
    if zc is not None:
        deltaX = deltaX + zc.deltaX
        deltaY = deltaY + zc.deltaY
        dX_dxs = dX_dxs + zc.dX_dxs
        dX_dys = dX_dys + zc.dX_dys
        dY_dxs = dY_dxs + zc.dY_dxs
        dY_dys = dY_dys + zc.dY_dys

    tang = [(i, s) for i, s in enumerate(spec.slots)
            if s.kind == DistortionType.TANGENTIAL_DISTORTION]
    if tang:
        bx = coeffs[spec.slot_index(DistortionType.TANGENTIAL_DISTORTION, -1)]
        by = coeffs[spec.slot_index(DistortionType.TANGENTIAL_DISTORTION, -2)]
        base_x = bx * (r2 + xxs2) + by * xys2
        base_y = by * (r2 + yys2) + bx * xys2
        dbase_x_dxs = 2.0 * (3.0 * bx * xs + by * ys)
        dbase_x_dys = 2.0 * (by * xs + bx * ys)
        dbase_y_dxs = 2.0 * (by * xs + bx * ys)
        dbase_y_dys = 2.0 * (bx * xs + 3.0 * by * ys)
        ssum = one
        for i, s in tang:
            if s.key <= 0:
                continue
            ssum = ssum + coeffs[i] * r2**s.order

    for i, slot in enumerate(spec.slots):
        k = slot.kind
        ci = coeffs[i]
        if k == DistortionType.AFFINITY_AND_SHEAR:
            if slot.key == 0:  # Cx
                deltaX = deltaX + ci * xs
                dX_dxs = dX_dxs + ci
                coeff_rows_x.append(xs)
                coeff_rows_y.append(zero)
            else:  # Cy
                deltaX = deltaX + ci * ys
                dX_dys = dX_dys + ci
                coeff_rows_x.append(ys)
                coeff_rows_y.append(zero)
        elif k == DistortionType.RADIAL_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            dradi = ci * dri
            deltaX = deltaX + xs * dradi
            deltaY = deltaY + ys * dradi
            const = ci * slot.order * r2 ** (slot.order - 1)
            dX_dxs = dX_dxs + xxs2 * const + dradi
            dX_dys = dX_dys + xys2 * const
            dY_dxs = dY_dxs + xys2 * const
            dY_dys = dY_dys + yys2 * const + dradi
            coeff_rows_x.append(xs * dri)
            coeff_rows_y.append(ys * dri)
        elif k == DistortionType.DISTANCE_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            ddisti = ci * dri / Ndn
            deltaX = deltaX + xs * ddisti
            deltaY = deltaY + ys * ddisti
            const = (ci * slot.order * r2 ** (slot.order - 1)) / Ndn
            dX_dxs = dX_dxs + xxs2 * const + ddisti
            dX_dys = dX_dys + xys2 * const
            dY_dxs = dY_dxs + xys2 * const
            dY_dys = dY_dys + yys2 * const + ddisti
            dX_dN = dX_dN - xs * ddisti / Ndn
            dY_dN = dY_dN - ys * ddisti / Ndn
            coeff_rows_x.append(xs * dri / Ndn)
            coeff_rows_y.append(ys * dri / Ndn)
        elif k == DistortionType.TANGENTIAL_DISTORTION:
            if slot.key == -1:  # Bx
                coeff_rows_x.append(ssum * (r2 + xxs2))
                coeff_rows_y.append(ssum * xys2)
            elif slot.key == -2:  # By
                coeff_rows_x.append(ssum * xys2)
                coeff_rows_y.append(ssum * (r2 + yys2))
            else:  # higher-order B_i
                ri = r2**slot.order
                coeff_rows_x.append(base_x * ri)
                coeff_rows_y.append(base_y * ri)
        elif zc is not None and i in zc.rows:
            rx, ry = zc.rows[i]
            coeff_rows_x.append(rx)
            coeff_rows_y.append(ry)
        else:  # pragma: no cover - guarded by supports_spec
            raise NotImplementedError(k)

    if tang:
        deltaX = deltaX + base_x * ssum
        deltaY = deltaY + base_y * ssum
        dsum_dxs = zero
        dsum_dys = zero
        for i, s in tang:
            if s.key <= 0:
                continue
            const = 2.0 * coeffs[i] * s.order * r2 ** (s.order - 1)
            dsum_dxs = dsum_dxs + xs * const
            dsum_dys = dsum_dys + ys * const
        dX_dxs = dX_dxs + ssum * dbase_x_dxs + base_x * dsum_dxs
        dX_dys = dX_dys + ssum * dbase_x_dys + base_x * dsum_dys
        dY_dxs = dY_dxs + ssum * dbase_y_dxs + base_y * dsum_dxs
        dY_dys = dY_dys + ssum * dbase_y_dys + base_y * dsum_dys

    rows_x = [cp_xs[j] + dX_dxs * dxs[j] + dX_dys * dys[j] + dX_dN * dN[j]
              for j in range(12)] + coeff_rows_x
    rows_y = [cp_ys[j] + dY_dxs * dxs[j] + dY_dys * dys[j] + dY_dN * dN[j]
              for j in range(12)] + coeff_rows_y

    pred_x = x0 + xs + deltaX
    pred_y = y0 + ys + deltaY
    return rows_x, rows_y, pred_x, pred_y
