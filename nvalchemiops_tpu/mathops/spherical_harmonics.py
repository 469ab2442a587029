# SPDX-License-Identifier: Apache-2.0
"""Real spherical harmonics for L <= 2 with analytical gradients.

JAX counterpart of ``nvalchemiops/math/spherical_harmonics.py``
(reference: math/spherical_harmonics.py:108-660).  Same conventions:

- Real harmonics ordered ``[Y00, Y1m1, Y10, Y1p1, Y2m2, Y2m1, Y20, Y2p1, Y2p2]``
  i.e. L=1 maps to (y, z, x) and L=2 to (xy, yz, 3z^2-r^2, xz, x^2-y^2).
- Normalization sqrt((2l+1)/4pi * (l-|m|)!/(l+|m|)!) with the usual real
  combination factors.
- Singularity at the origin regularized with EPSILON = 1e-30 added to r^2.

All functions are vectorized over a leading batch of position vectors and are
plain jnp code, so ``jit``/``vmap``/Pallas all apply.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

Y00_COEFF = 0.28209479177387814  # 1/sqrt(4 pi)
Y1_COEFF = 0.4886025119029199  # sqrt(3/(4 pi))
Y2_M2_COEFF = 1.0925484305920792  # sqrt(15/(4 pi))
Y2_M1_COEFF = 1.0925484305920792
Y2_0_COEFF = 0.31539156525252005  # sqrt(5/(16 pi))
Y2_P1_COEFF = 1.0925484305920792
Y2_P2_COEFF = 0.5462742152960396  # sqrt(15/(16 pi))

EPSILON = 1e-30

_ = math  # placate linters; constants above are pre-evaluated


def eval_spherical_harmonics_l0(r):
    """Y_0^0 for positions ``r`` [..., 3] -> [..., 1]."""
    shape = r.shape[:-1] + (1,)
    return jnp.full(shape, Y00_COEFF, dtype=r.dtype)


def eval_spherical_harmonics_l1(r):
    """(Y_1^-1, Y_1^0, Y_1^+1) ~ (y, z, x)/r for ``r`` [..., 3] -> [..., 3]."""
    r2 = jnp.sum(r * r, axis=-1, keepdims=True)
    r_inv = 1.0 / jnp.sqrt(r2 + EPSILON)
    x, y, z = r[..., 0:1], r[..., 1:2], r[..., 2:3]
    return Y1_COEFF * jnp.concatenate([y, z, x], axis=-1) * r_inv


def eval_spherical_harmonics_l2(r):
    """Five L=2 real harmonics for ``r`` [..., 3] -> [..., 5]."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    r2 = x * x + y * y + z * z + EPSILON
    r2_inv = 1.0 / r2
    out = jnp.stack(
        [
            Y2_M2_COEFF * x * y * r2_inv,
            Y2_M1_COEFF * y * z * r2_inv,
            Y2_0_COEFF * (3.0 * z * z - r2) * r2_inv,
            Y2_P1_COEFF * x * z * r2_inv,
            Y2_P2_COEFF * (x * x - y * y) * r2_inv,
        ],
        axis=-1,
    )
    return out


def eval_all_spherical_harmonics(r):
    """All nine harmonics (L=0..2) for ``r`` [..., 3] -> [..., 9]."""
    return jnp.concatenate(
        [
            eval_spherical_harmonics_l0(r),
            eval_spherical_harmonics_l1(r),
            eval_spherical_harmonics_l2(r),
        ],
        axis=-1,
    )


def spherical_harmonics(positions, l_max: int = 2):
    """Evaluate real spherical harmonics up to ``l_max`` (0, 1 or 2).

    Parameters
    ----------
    positions : jnp.ndarray [..., 3]
    l_max : int
        Maximum angular momentum.

    Returns
    -------
    jnp.ndarray [..., num_components] with num_components in {1, 4, 9}.
    """
    if l_max == 0:
        return eval_spherical_harmonics_l0(positions)
    if l_max == 1:
        return jnp.concatenate(
            [eval_spherical_harmonics_l0(positions), eval_spherical_harmonics_l1(positions)],
            axis=-1,
        )
    if l_max == 2:
        return eval_all_spherical_harmonics(positions)
    raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")


def spherical_harmonics_gradient(positions, l_max: int = 2):
    """Analytical gradients of the real spherical harmonics.

    Returns [..., num_components, 3] — gradient of each harmonic with respect
    to the Cartesian components of ``positions``.  Matches the closed forms of
    the reference ``spherical_harmonic_*_gradient`` device functions.
    """
    x, y, z = positions[..., 0], positions[..., 1], positions[..., 2]
    r2 = x * x + y * y + z * z + EPSILON
    r_inv = 1.0 / jnp.sqrt(r2)
    r2_inv = 1.0 / r2
    r3_inv = r_inv * r2_inv
    r4_inv = r2_inv * r2_inv
    zeros = jnp.zeros_like(x)

    grads = []
    # L=0: constant -> zero gradient
    g00 = jnp.stack([zeros, zeros, zeros], axis=-1)

    # L=1: grad (c*u/r) for u in {y, z, x}
    # d/dv (u/r) = delta_uv / r - u*v / r^3
    g1m1 = Y1_COEFF * jnp.stack(
        [-x * y * r3_inv, r_inv - y * y * r3_inv, -y * z * r3_inv], axis=-1
    )
    g10 = Y1_COEFF * jnp.stack(
        [-x * z * r3_inv, -y * z * r3_inv, r_inv - z * z * r3_inv], axis=-1
    )
    g1p1 = Y1_COEFF * jnp.stack(
        [r_inv - x * x * r3_inv, -x * y * r3_inv, -x * z * r3_inv], axis=-1
    )

    # L=2: grad (c*u*v/r^2) = c*(grad(u*v)/r^2 - 2*u*v*r_vec/r^4)
    g2m2 = Y2_M2_COEFF * jnp.stack(
        [
            y * r2_inv - 2.0 * x * x * y * r4_inv,
            x * r2_inv - 2.0 * x * y * y * r4_inv,
            -2.0 * x * y * z * r4_inv,
        ],
        axis=-1,
    )
    g2m1 = Y2_M1_COEFF * jnp.stack(
        [
            -2.0 * x * y * z * r4_inv,
            z * r2_inv - 2.0 * y * y * z * r4_inv,
            y * r2_inv - 2.0 * y * z * z * r4_inv,
        ],
        axis=-1,
    )
    # Y20 = c*(3z^2 - r^2)/r^2 = c*(3z^2/r^2 - 1)
    g20 = Y2_0_COEFF * jnp.stack(
        [
            -6.0 * x * z * z * r4_inv,
            -6.0 * y * z * z * r4_inv,
            6.0 * z * r2_inv - 6.0 * z * z * z * r4_inv,
        ],
        axis=-1,
    )
    g2p1 = Y2_P1_COEFF * jnp.stack(
        [
            z * r2_inv - 2.0 * x * x * z * r4_inv,
            -2.0 * x * y * z * r4_inv,
            x * r2_inv - 2.0 * x * z * z * r4_inv,
        ],
        axis=-1,
    )
    # Y2p2 = c*(x^2 - y^2)/r^2
    g2p2 = Y2_P2_COEFF * jnp.stack(
        [
            2.0 * x * r2_inv - 2.0 * x * (x * x - y * y) * r4_inv,
            -2.0 * y * r2_inv - 2.0 * y * (x * x - y * y) * r4_inv,
            -2.0 * z * (x * x - y * y) * r4_inv,
        ],
        axis=-1,
    )

    if l_max >= 0:
        grads.append(g00[..., None, :])
    if l_max >= 1:
        grads.extend([g1m1[..., None, :], g10[..., None, :], g1p1[..., None, :]])
    if l_max >= 2:
        grads.extend(
            [
                g2m2[..., None, :],
                g2m1[..., None, :],
                g20[..., None, :],
                g2p1[..., None, :],
                g2p2[..., None, :],
            ]
        )
    if l_max > 2:
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    return jnp.concatenate(grads, axis=-2)


# ---------------------------------------------------------------------------
# Per-component accessors (reference: math/spherical_harmonics.py:136-660
# exposes one device function per harmonic and per gradient).  Generated
# thin wrappers over the vectorized evaluators; each takes positions
# [..., 3] and returns the scalar harmonic [...] (or its gradient [..., 3]).
# ---------------------------------------------------------------------------

_COMPONENT_NAMES = ("00", "1m1", "10", "1p1", "2m2", "2m1", "20", "2p1", "2p2")


def _make_component(idx: int, name: str):
    def _value(positions):
        return eval_all_spherical_harmonics(jnp.asarray(positions))[..., idx]

    def _gradient(positions):
        return spherical_harmonics_gradient(jnp.asarray(positions))[..., idx, :]

    _value.__name__ = f"spherical_harmonic_{name}"
    _value.__qualname__ = _value.__name__
    _value.__doc__ = (f"Real harmonic Y_{name} at positions [..., 3] -> [...] "
                      "(vectorized counterpart of the reference's device fn).")
    _gradient.__name__ = f"spherical_harmonic_{name}_gradient"
    _gradient.__qualname__ = _gradient.__name__
    _gradient.__doc__ = (f"Gradient of Y_{name} w.r.t. position [..., 3] -> "
                         "[..., 3].")
    return _value, _gradient


for _idx, _name in enumerate(_COMPONENT_NAMES):
    _v, _g = _make_component(_idx, _name)
    globals()[_v.__name__] = _v
    globals()[_g.__name__] = _g
del _idx, _name, _v, _g
