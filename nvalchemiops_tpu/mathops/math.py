# SPDX-License-Identifier: Apache-2.0
"""Scalar math helpers (reference: nvalchemiops/math/math.py).

All functions are elementwise jnp expressions: they work on traced arrays,
under ``vmap``/``jit``, and inside Pallas kernel bodies.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def divmod_floor(a, n):
    """Floor division and remainder with the sign convention of Python's divmod.

    Used for periodic wrapping of cell indices: for any integer ``a`` and
    positive ``n``, returns ``(d, m)`` with ``a = d*n + m`` and ``0 <= m < n``
    (reference semantics: math/math.py:40-48).
    """
    d = jnp.floor_divide(a, n)
    m = a - d * n
    return d, m


def safe_divide(num, den, eps=1e-12):
    """``num/den`` with denominators smaller than ``eps`` mapped to 0."""
    den_arr = jnp.asarray(den)
    small = jnp.abs(den_arr) < eps
    safe_den = jnp.where(small, jnp.ones_like(den_arr), den_arr)
    return jnp.where(small, jnp.zeros_like(num / safe_den), num / safe_den)


def exp_over_x(x, prefactor):
    """``exp(-prefactor * x) / x`` — the Ewald Green's-function radial factor.

    (reference: math/math.py:30-37 / pme_kernels.py:109-113).
    """
    return jnp.exp(-prefactor * x) / x


def erfc_approx(x):
    """Complementary error function via the Abramowitz–Stegun 7.1.26 polynomial.

    Max absolute error ~1.5e-7 — identical accuracy class to the device-side
    approximation the reference uses in all its electrostatics kernels
    (reference: math/math.py:51-93).  Unlike ``jax.scipy.special.erfc`` this
    consists only of mul/add/exp and fuses into any elementwise kernel.

    Supports negative arguments through ``erfc(-x) = 2 - erfc(x)``.
    """
    x = jnp.asarray(x)
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5 = -1.453152027, 1.061405429
    p = 0.3275911
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = poly * jnp.exp(-ax * ax)
    return jnp.where(x >= 0, y, 2.0 - y)


def sinc_normalized(x):
    """Normalized sinc ``sin(pi x)/(pi x)`` with a stable value of 1 at 0.

    (reference: pme_kernels.py:93-107).
    """
    x = jnp.asarray(x)
    small = jnp.abs(x) < 1e-6
    safe = jnp.where(small, jnp.ones_like(x), x)
    pix = jnp.pi * safe
    return jnp.where(small, jnp.ones_like(x), jnp.sin(pix) / pix)


def apply_mat3(vecs, m):
    """``vecs [.., 3] @ m [3, 3]`` as broadcast multiply-adds (exact f32).

    A backend may run even tiny f32 matmuls at reduced precision (bf16
    passes, or TF32 on a GPU) — with bf16 operands a ``positions @
    inv_cell`` dot cost 4.5% energy / 16% force error in the dense
    Coulomb path.  Coordinate transforms, force rotations, and k.r
    phases stay elementwise in full f32; this helper (and its phase
    sibling) is the spelling to use.
    """
    return (vecs[..., 0:1] * m[0] + vecs[..., 1:2] * m[1]
            + vecs[..., 2:3] * m[2])


def dot_phases(positions, k_vectors):
    """``positions [.., n, 3] @ k_vectors [.., k, 3]^T`` exactly.

    The K=3 contraction is three broadcast outer products — no matmul, no
    reduced-precision truncation of coordinates or k-vectors (see
    :func:`apply_mat3`).
    """
    px = positions[..., :, 0:1]
    py = positions[..., :, 1:2]
    pz = positions[..., :, 2:3]
    kx = k_vectors[..., None, :, 0]
    ky = k_vectors[..., None, :, 1]
    kz = k_vectors[..., None, :, 2]
    return px * kx + py * ky + pz * kz


# ---------------------------------------------------------------------------
# Compensated mesh coordinates
# ---------------------------------------------------------------------------
#
# A B-spline stencil needs theta = frac(u) for u = (r @ cell^-1) * n.  In
# f32, u ~ 128 carries an ulp of 7.6e-6 and the f32 inverse a relative
# error of ~1e-7, so theta comes out ~1e-5 off — which the 1/k^2 Green's
# function turns into ~1e-4 relative PME force error on a 110k-atom,
# 128^3 crystal.  The error-free transformations below (Dekker's split and
# product, Knuth's two-sum) carry u as an unevaluated sum hi + lo, which
# puts theta within a few ulps of 1.


def _split(a):
    bits = jnp.finfo(a.dtype).nmant + 1
    c = a * float(2 ** math.ceil(bits / 2) + 1)
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, al * bl - (((p - ah * bh) - al * bh) - ah * bl)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dot2(x, m):
    """``sum_d x[..., d, None] * m[..., d, :]`` as ``(hi, lo)``."""
    p, s = _two_prod(x[..., 0:1], m[..., 0, :])
    for d in (1, 2):
        h, r = _two_prod(x[..., d:d + 1], m[..., d, :])
        p, q = _two_sum(p, h)
        s = s + (q + r)
    return p, s


def mesh_coordinates(positions, mesh_dims, cell=None, inv=None):
    """Mesh-scaled fractional coordinates as ``(base, theta)``, compensated.

    ``u = (positions @ cell^-1) * mesh_dims`` per atom; returns the wrapped
    integer base ``floor(u) mod mesh_dims`` (int32 ``[..., 3]``) and
    ``theta = u - floor(u)`` in ``[0, 1)`` to within a few ulps of 1 (see
    the note above).  ``cell`` and ``inv`` are ``[3, 3]`` or per-atom
    ``[..., 3, 3]`` (rows are lattice vectors).  With ``cell`` the inverse
    (``inv`` if given) is refined once against it; ``inv`` alone is used
    as it stands.
    """
    positions = jnp.asarray(positions)
    dtype = positions.dtype
    x = jnp.linalg.inv(jnp.asarray(cell, dtype)) if inv is None else (
        jnp.asarray(inv, dtype))
    f_hi, f_lo = _dot2(positions, x)
    if cell is not None:
        # one refinement step: cell^-1 = x + x (I - cell x), the residual
        # taken in twice the working precision (1 - hi is exact near I)
        hi, lo = _dot2(jnp.asarray(cell, dtype), x[..., None, :, :])
        resid = (jnp.eye(3, dtype=dtype) - hi) - lo
        dx = jnp.sum(x[..., :, :, None] * resid[..., None, :, :], axis=-2)
        f_lo = f_lo + jnp.sum(positions[..., :, None] * dx, axis=-2)
    dims = jnp.asarray(mesh_dims, dtype)
    u_hi, e = _two_prod(f_hi, dims)
    u_lo = e + f_lo * dims
    base = jnp.floor(u_hi)
    theta = (u_hi - base) + u_lo
    carry = jnp.floor(theta)
    base = base + carry
    theta = theta - carry
    # theta can round up to exactly 1.0 from just below
    over = theta >= 1.0
    base = jnp.where(over, base + 1.0, base)
    theta = jnp.where(over, 0.0, theta)
    base_i = jnp.mod(base.astype(jnp.int32),
                     jnp.asarray(mesh_dims, jnp.int32))
    return base_i, theta
