# SPDX-License-Identifier: Apache-2.0
"""Batched windowed PME vs the single-system path."""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.interactions.electrostatics.pme import (
    batch_pme_reciprocal,
    pme_reciprocal_space,
)


def test_batch_windowed_pme_matches_single():
    rng = np.random.default_rng(0)
    B, npa, box = 3, 400, 24.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, npa)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    mesh = (32, 32, 32)
    e_b, f_b = batch_pme_reciprocal(pos, q, cell, 0.4, mesh,
                                    compute_forces=True)
    for b in range(B):
        e1, f1 = pme_reciprocal_space(pos[b], q[b], cell, 0.4,
                                      mesh_dimensions=mesh,
                                      compute_forces=True)
        np.testing.assert_allclose(np.asarray(e_b[b]), np.asarray(e1),
                                   atol=3e-5, rtol=2e-5)
        np.testing.assert_allclose(np.asarray(f_b[b]), np.asarray(f1),
                                   atol=3e-5)


def test_batch_windowed_pme_rejects_bad_mesh():
    pos = jnp.zeros((2, 10, 3), jnp.float32)
    q = jnp.zeros((2, 10), jnp.float32)
    cell = jnp.eye(3, dtype=jnp.float32) * 10
    with pytest.raises(ValueError):
        batch_pme_reciprocal(pos, q, cell, 0.4, (30, 30, 30))


def test_batch_pme_matmul_fft_mode_matches_xla():
    from nvalchemiops_tpu.interactions.electrostatics import (
        batch_pme_reciprocal,
    )

    rng = np.random.default_rng(9)
    B, npa, box = 3, 60, 6.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, npa)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    e_x, f_x = batch_pme_reciprocal(pos, q, cell, 0.8, (16, 16, 16),
                                    compute_forces=True, fft_mode="xla")
    e_m, f_m = batch_pme_reciprocal(pos, q, cell, 0.8, (16, 16, 16),
                                    compute_forces=True, fft_mode="matmul")
    np.testing.assert_allclose(np.asarray(e_m), np.asarray(e_x), atol=2e-4)
    np.testing.assert_allclose(np.asarray(f_m), np.asarray(f_x), atol=2e-4)


def test_batch_pme_dense_engine_matches_windowed():
    rng = np.random.default_rng(7)
    B, npa, box = 3, 80, 10.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, npa)), jnp.float32)
    q = q - q.mean(axis=1, keepdims=True)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    mesh = (16, 16, 16)
    kw = dict(compute_forces=True, compute_charge_gradients=True)
    e_w, f_w, g_w = batch_pme_reciprocal(pos, q, cell, 0.5, mesh,
                                         engine="windowed", **kw)
    e_d, f_d, g_d = batch_pme_reciprocal(pos, q, cell, 0.5, mesh,
                                         engine="dense", **kw)
    np.testing.assert_allclose(np.asarray(e_d), np.asarray(e_w),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(f_d), np.asarray(f_w), atol=2e-5)
    np.testing.assert_allclose(np.asarray(g_d), np.asarray(g_w), atol=2e-5)


def test_batch_pme_charge_gradients_match_autodiff():
    import jax

    rng = np.random.default_rng(4)
    B, npa, box = 2, 50, 6.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float64)
    q = jnp.asarray(rng.normal(size=(B, npa)), jnp.float64)
    cell = jnp.asarray(np.eye(3) * box, jnp.float64)

    e, cg = batch_pme_reciprocal(pos, q, cell, 0.8, (16, 16, 16),
                                 compute_charge_gradients=True)
    want = jax.grad(
        lambda qq: jnp.sum(batch_pme_reciprocal(pos, qq, cell, 0.8,
                                                (16, 16, 16))))(q)
    np.testing.assert_allclose(np.asarray(cg), np.asarray(want),
                               rtol=1e-8, atol=1e-10)
