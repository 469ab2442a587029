# SPDX-License-Identifier: Apache-2.0
"""Math building-block tests: erfc, divmod, sinc, spherical harmonics, GTO."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.special import erfc as scipy_erfc

from nvalchemiops_tpu.mathops import (
    divmod_floor,
    erfc_approx,
    eval_gto_density,
    eval_gto_fourier,
    gto_normalization,
    gto_self_overlap,
    safe_divide,
    sinc_normalized,
    spherical_harmonics,
    spherical_harmonics_gradient,
)


def test_erfc_approx_accuracy():
    x = jnp.linspace(-4.0, 6.0, 2001)
    err = np.abs(np.asarray(erfc_approx(x)) - scipy_erfc(np.asarray(x)))
    assert err.max() < 2e-7  # Abramowitz-Stegun 7.1.26 bound


def test_divmod_floor():
    a = jnp.asarray([-7, -1, 0, 1, 7, 13])
    d, m = divmod_floor(a, 5)
    np.testing.assert_array_equal(np.asarray(d), [-2, -1, 0, 0, 1, 2])
    np.testing.assert_array_equal(np.asarray(m), [3, 4, 0, 1, 2, 3])


def test_safe_divide_and_sinc():
    out = safe_divide(jnp.asarray([1.0, 2.0]), jnp.asarray([0.0, 4.0]))
    np.testing.assert_allclose(np.asarray(out), [0.0, 0.5])
    x = jnp.asarray([0.0, 1e-9, 0.5, 1.0, 2.0])
    s = np.asarray(sinc_normalized(x))
    np.testing.assert_allclose(s, np.sinc(np.asarray(x)), atol=1e-12)


def test_spherical_harmonics_orthonormality():
    # Monte-Carlo integral over the sphere: <Y_a Y_b> = delta_ab / (4 pi) * 4 pi
    rng = np.random.default_rng(0)
    v = rng.normal(size=(200000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    y = np.asarray(spherical_harmonics(jnp.asarray(v), l_max=2))  # [M, 9]
    gram = 4.0 * np.pi * (y.T @ y) / v.shape[0]
    np.testing.assert_allclose(gram, np.eye(9), atol=0.05)


def test_spherical_harmonics_scale_invariance():
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=(50, 3)))
    y1 = spherical_harmonics(v)
    y2 = spherical_harmonics(3.7 * v)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-10)


def test_spherical_harmonics_gradient_matches_autodiff():
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.normal(size=(20, 3)) * 2.0)
    g_analytic = np.asarray(spherical_harmonics_gradient(v, l_max=2))  # [N, 9, 3]
    jac = jax.vmap(jax.jacobian(lambda r: spherical_harmonics(r, l_max=2)))(v)
    np.testing.assert_allclose(g_analytic, np.asarray(jac), atol=1e-10)


def test_gto_monopole_normalization():
    # integral of phi_00 over R^3 == 1 (radial quadrature)
    sigma = 0.8
    r = np.linspace(0, 12 * sigma, 20000)
    pos = jnp.stack([jnp.asarray(r), jnp.zeros_like(jnp.asarray(r)), jnp.zeros_like(jnp.asarray(r))], axis=-1)
    phi = np.asarray(eval_gto_density(pos, sigma, l_max=0))[:, 0]
    integral = np.trapezoid(4 * np.pi * r**2 * phi, r)
    np.testing.assert_allclose(integral, 1.0, rtol=1e-6)


def test_gto_self_overlap_value():
    sigma = 0.7
    # <phi_00|phi_00> via radial quadrature
    r = np.linspace(0, 12 * sigma, 40000)
    pos = jnp.stack([jnp.asarray(r), jnp.zeros_like(jnp.asarray(r)), jnp.zeros_like(jnp.asarray(r))], axis=-1)
    phi = np.asarray(eval_gto_density(pos, sigma, l_max=0))[:, 0]
    integral = np.trapezoid(4 * np.pi * r**2 * phi**2, r)
    np.testing.assert_allclose(integral, float(gto_self_overlap(0, sigma)), rtol=1e-6)


def test_gto_fourier_consistency():
    # FT of the monopole: phi_hat(k) = exp(-k^2 sigma^2 / 2); check against a
    # numerical 1-D radial Hankel transform of the density
    sigma = 0.9
    k = 1.3
    real, imag = eval_gto_fourier(jnp.asarray([[k, 0.0, 0.0]]), sigma, l_max=2)
    np.testing.assert_allclose(float(real[0, 0]), np.exp(-(k * sigma) ** 2 / 2), rtol=1e-10)
    # l=0 and l=2 are real, l=1 imaginary
    assert np.allclose(np.asarray(imag)[0, 0], 0.0)
    assert np.allclose(np.asarray(real)[0, 1:4], 0.0)
    assert np.allclose(np.asarray(imag)[0, 4:], 0.0)


def test_gto_normalization_formula():
    sigma = 1.1
    expected = np.sqrt(4 * np.pi) / (2 * np.pi) ** 1.5 / sigma**3
    np.testing.assert_allclose(float(gto_normalization(sigma)), expected, rtol=1e-12)


def test_per_component_spherical_harmonic_accessors():
    import nvalchemiops_tpu.mathops as m

    r = jnp.asarray(np.random.default_rng(0).normal(size=(7, 3)))
    y = m.eval_all_spherical_harmonics(r)
    g = m.spherical_harmonics_gradient(r)
    names = ("00", "1m1", "10", "1p1", "2m2", "2m1", "20", "2p1", "2p2")
    for i, n in enumerate(names):
        np.testing.assert_allclose(
            np.asarray(getattr(m, f"spherical_harmonic_{n}")(r)),
            np.asarray(y[..., i]), rtol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(getattr(m, f"spherical_harmonic_{n}_gradient")(r)),
            np.asarray(g[..., i, :]), rtol=1e-12,
        )


def test_gto_per_l_wrappers_match_vectorized():
    import nvalchemiops_tpu.mathops as m

    rng = np.random.default_rng(3)
    r = jnp.asarray(rng.normal(size=(9, 3)))
    k = jnp.asarray(rng.normal(size=(9, 3)))
    sigma = 0.8
    dens = m.eval_gto_density(r, sigma, l_max=2)
    np.testing.assert_allclose(np.asarray(m.gto_density_l0(r, sigma)), np.asarray(dens[..., 0]))
    np.testing.assert_allclose(np.asarray(m.gto_density_l1(r, sigma)), np.asarray(dens[..., 1:4]))
    np.testing.assert_allclose(np.asarray(m.gto_density_l2(r, sigma)), np.asarray(dens[..., 4:9]))
    np.testing.assert_allclose(np.asarray(m.gto_density_all(r, sigma)), np.asarray(dens))
    re, im = m.eval_gto_fourier(k, sigma, l_max=2)
    np.testing.assert_allclose(np.asarray(m.gto_fourier_l0(k, sigma)), np.asarray(re[..., 0]))
    np.testing.assert_allclose(np.asarray(m.gto_fourier_l1_real(k, sigma)), 0.0)
    np.testing.assert_allclose(np.asarray(m.gto_fourier_l1_imag(k, sigma)), np.asarray(im[..., 1:4]))
    np.testing.assert_allclose(np.asarray(m.gto_fourier_l2_real(k, sigma)), np.asarray(re[..., 4:9]))
    r2 = jnp.sum(r * r, axis=-1)
    np.testing.assert_allclose(
        np.asarray(m.gto_gaussian_factor(r2, sigma)),
        np.exp(-np.asarray(r2) / (2 * sigma**2)),
    )
    assert float(m.gto_integral_l0(sigma)) == 1.0


def test_gto_density_l0_gradient_finite_difference():
    import nvalchemiops_tpu.mathops as m

    r = jnp.asarray(np.random.default_rng(5).normal(size=(6, 3)))
    sigma = 0.7
    g = m.gto_density_l0_gradient(r, sigma)
    eps = 1e-6
    for d in range(3):
        fd = (m.gto_density_l0(r.at[:, d].add(eps), sigma)
              - m.gto_density_l0(r.at[:, d].add(-eps), sigma)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g[:, d]), np.asarray(fd), atol=1e-8)


def test_matmul_rfft_convolve_matches_fft():
    """Matmul DFT convolution == rfftn/irfftn pipeline (all shapes)."""
    from nvalchemiops_tpu.mathops.matmul_dft import matmul_rfft_convolve

    rng = np.random.default_rng(0)
    for shape in [(8, 8, 8), (16, 12, 10), (3, 16, 16, 16), (9, 7, 11)]:
        mesh = jnp.asarray(rng.normal(size=shape), jnp.float32)
        nx, ny, nz = shape[-3:]
        kern = jnp.asarray(rng.normal(size=(nx, ny, nz // 2 + 1)),
                           jnp.float32)
        want = jnp.fft.irfftn(
            jnp.fft.rfftn(mesh, norm="backward", axes=(-3, -2, -1)) * kern,
            s=(nx, ny, nz), norm="forward", axes=(-3, -2, -1))
        got = matmul_rfft_convolve(mesh, kern)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=5e-5 * float(jnp.max(jnp.abs(want))))
