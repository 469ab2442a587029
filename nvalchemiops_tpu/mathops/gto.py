# SPDX-License-Identifier: Apache-2.0
"""Gaussian-type-orbital densities and analytic Fourier transforms (L <= 2).

JAX counterpart of ``nvalchemiops/math/gto.py`` (reference:
math/gto.py:143-860).  Conventions:

- Density: ``phi_{l,m}(r, sigma) = N * Y_l^m(r_hat) * exp(-r^2 / (2 sigma^2))``
  with ``N = sqrt(4 pi) / (2 pi)^{3/2} / sigma^3`` so the monopole integrates
  to 1.
- Fourier transform: ``phi_hat_{l,m}(k) = (i/2)^l sqrt(4 pi) Y_l^m(k_hat)
  exp(-k^2 sigma^2 / 2)`` — purely real for L in {0, 2}, purely imaginary for
  L = 1.  ``sigma = 1/(2 alpha)`` links the width to an Ewald splitting
  parameter.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from nvalchemiops_tpu.mathops.spherical_harmonics import (
    eval_all_spherical_harmonics,
    spherical_harmonics,
)

SQRT_4PI = math.sqrt(4.0 * math.pi)
TWOPI = 2.0 * math.pi

_NUM_COMPONENTS = {0: 1, 1: 4, 2: 9}


def gto_normalization(sigma):
    """Normalization ``N = sqrt(4 pi) / ((2 pi)^{3/2} sigma^3)``."""
    return SQRT_4PI / (TWOPI * jnp.sqrt(jnp.asarray(TWOPI, dtype=jnp.result_type(sigma, 1.0))) * sigma**3)


def gto_self_overlap(l: int, sigma):
    """Self-overlap ``<phi_{l,m} | phi_{l,m}> = 1 / (8 pi^{3/2} sigma^3)``.

    Independent of l (the real harmonics are orthonormal on the sphere).
    Note: the reference's closed form ``1/(2 sqrt(pi) sigma^3)``
    (math/gto.py:480-525) is inconsistent with its own density
    normalization by exactly a factor 4 pi (it drops |Y_00|^2 = 1/(4 pi));
    this implementation returns the value consistent with
    :func:`eval_gto_density`, verified by quadrature in the tests.
    """
    del l
    pi = jnp.asarray(math.pi, dtype=jnp.result_type(sigma, 1.0))
    return 1.0 / (8.0 * pi * jnp.sqrt(pi) * sigma**3)


def eval_gto_density(positions, sigma, l_max: int = 2):
    """GTO density components at ``positions`` [..., 3] -> [..., n_comp].

    ``n_comp`` is 1/4/9 for ``l_max`` 0/1/2, ordered like
    :func:`~nvalchemiops_tpu.mathops.spherical_harmonics.spherical_harmonics`.
    """
    if l_max not in _NUM_COMPONENTS:
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    r2 = jnp.sum(positions * positions, axis=-1, keepdims=True)
    prefactor = gto_normalization(sigma) * jnp.exp(-r2 / (2.0 * sigma**2))
    return prefactor * spherical_harmonics(positions, l_max=l_max)


def gto_gaussian_factor(r2, sigma):
    """Radial factor ``exp(-r^2 / (2 sigma^2))`` (reference: math/gto.py:169-192)."""
    return jnp.exp(-jnp.asarray(r2) / (2.0 * sigma**2))


def gto_integral_l0(sigma):
    """Integral of the monopole GTO over all space — 1 by construction
    (reference: math/gto.py:456-478)."""
    return jnp.ones_like(jnp.asarray(sigma, dtype=jnp.result_type(sigma, 1.0)))


def gto_density_l0(positions, sigma):
    """Monopole density ``phi_00`` at ``positions`` [..., 3] -> [...]
    (reference: math/gto.py:193-219)."""
    return eval_gto_density(positions, sigma, l_max=0)[..., 0]


def gto_density_l1(positions, sigma):
    """Dipole densities ``phi_1m`` [..., 3] (m = -1, 0, +1 ordering of
    :func:`spherical_harmonics`; reference: math/gto.py:220-260)."""
    return eval_gto_density(positions, sigma, l_max=1)[..., 1:4]


def gto_density_l2(positions, sigma):
    """Quadrupole densities ``phi_2m`` [..., 5]
    (reference: math/gto.py:261-304)."""
    return eval_gto_density(positions, sigma, l_max=2)[..., 4:9]


def gto_density_all(positions, sigma):
    """All nine L <= 2 density components [..., 9]
    (reference: math/gto.py:532-587)."""
    return eval_gto_density(positions, sigma, l_max=2)


def gto_density_l0_gradient(positions, sigma):
    """``grad phi_00 = -phi_00 r / sigma^2`` [..., 3]
    (reference: math/gto.py:588-624)."""
    phi = gto_density_l0(positions, sigma)
    return (-phi / sigma**2)[..., None] * positions


def gto_fourier_l0(k_vectors, sigma):
    """Real monopole Fourier component [...] (reference: math/gto.py:305-335)."""
    return eval_gto_fourier(k_vectors, sigma, l_max=0)[0][..., 0]


def gto_fourier_l1_real(k_vectors, sigma):
    """Real part of the dipole Fourier components — identically zero
    (reference: math/gto.py:336-381)."""
    return eval_gto_fourier(k_vectors, sigma, l_max=1)[0][..., 1:4]


def gto_fourier_l1_imag(k_vectors, sigma):
    """Imaginary part of the dipole Fourier components [..., 3]
    (reference: math/gto.py:382-403)."""
    return eval_gto_fourier(k_vectors, sigma, l_max=1)[1][..., 1:4]


def gto_fourier_l2_real(k_vectors, sigma):
    """Real quadrupole Fourier components [..., 5]
    (reference: math/gto.py:404-455)."""
    return eval_gto_fourier(k_vectors, sigma, l_max=2)[0][..., 4:9]


def eval_gto_fourier(k_vectors, sigma, l_max: int = 2):
    """Analytic Fourier transform of the GTO basis at ``k_vectors`` [..., 3].

    Returns ``(real, imag)`` arrays of shape [..., n_comp]: L=0 and L=2
    components are purely real (L=2 carries the ``(i/2)^2 = -1/4`` sign),
    L=1 components are purely imaginary with coefficient
    ``(1/2) sqrt(4 pi) Y_1^m exp(-k^2 sigma^2 / 2)``.
    """
    if l_max not in _NUM_COMPONENTS:
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    k2 = jnp.sum(k_vectors * k_vectors, axis=-1, keepdims=True)
    gauss = jnp.exp(-k2 * sigma**2 / 2.0)
    y = eval_all_spherical_harmonics(k_vectors)

    zeros = jnp.zeros_like(y[..., 0:1])
    # (i/2)^l * sqrt(4pi): l=0 -> 1 (real), l=1 -> i/2 (imag), l=2 -> -1/4 (real)
    real_parts = [SQRT_4PI * y[..., 0:1] * gauss]
    imag_parts = [zeros]
    if l_max >= 1:
        real_parts.append(jnp.broadcast_to(zeros, y[..., 1:4].shape))
        imag_parts.append(0.5 * SQRT_4PI * y[..., 1:4] * gauss)
    if l_max >= 2:
        real_parts.append(-0.25 * SQRT_4PI * y[..., 4:9] * gauss)
        imag_parts.append(jnp.broadcast_to(zeros, y[..., 4:9].shape))
    return (
        jnp.concatenate(real_parts, axis=-1),
        jnp.concatenate(imag_parts, axis=-1),
    )
