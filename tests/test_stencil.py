# SPDX-License-Identifier: Apache-2.0
"""Voxel-stencil sweep tests: geometry search, build validity, Coulomb
parity with the row-grid engine (the established oracle-backed path)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.grid import build_atom_grid_auto, grid_coulomb_energy_forces
from nvalchemiops_tpu.stencil import (
    build_stencil_auto,
    build_stencil_grid,
    choose_stencil_geometry,
    gather_from_stencil,
    scatter_to_stencil,
    stencil_coulomb_energy_forces,
)


def _crystal(n_rep=8, a=3.0, jitter=0.2, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    gpts = np.stack(
        np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"), -1
    ).reshape(-1, 3) * a
    pos = jnp.asarray(gpts + rng.uniform(-jitter, jitter, gpts.shape), dtype)
    cell = jnp.asarray(np.eye(3) * (n_rep * a), dtype)
    return pos, cell


def test_choose_stencil_geometry_crystal():
    pos, cell = _crystal()
    pbc = np.array([True] * 3)
    geo = choose_stencil_geometry(pos, cell, pbc, 6.5)
    assert geo is not None
    dims, radius, origin, occ = geo
    assert occ == 1
    # bins must cover the cutoff: radius * bin >= cutoff on each axis
    for d, r in zip(dims, radius):
        assert r * (24.0 / d) >= 6.5 - 1e-6


def test_choose_stencil_geometry_rejects_dense_overlap():
    # two atoms closer than any reasonable bin -> no occupancy-1 binning
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.uniform(0, 10.0, (600, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * 10.0, jnp.float32)
    geo = choose_stencil_geometry(pos, cell, np.array([True] * 3), 4.0)
    # dense random gas at ~0.6/A^3: every candidate binning overflows
    assert geo is None or geo[3] <= 1


def test_scatter_gather_roundtrip():
    pos, cell = _crystal()
    pbc = np.array([True] * 3)
    sg = build_stencil_auto(pos, cell, pbc, 6.5)
    assert sg is not None
    assert int(sg.counts_max) == 1
    vals = jnp.arange(pos.shape[0], dtype=jnp.float32)
    back = gather_from_stencil(sg, scatter_to_stencil(sg, vals))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(vals))


@pytest.mark.parametrize("alpha", [0.0, 0.35])
def test_stencil_coulomb_matches_grid(alpha):
    pos, cell = _crystal()
    pbc = np.array([True] * 3)
    cutoff = 6.5
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=pos.shape[0]), jnp.float32)

    sg = build_stencil_auto(pos, cell, pbc, cutoff)
    g = build_atom_grid_auto(pos, cell, pbc, cutoff)
    e_ref, f_ref = grid_coulomb_energy_forces(g, q, cutoff, alpha)
    e_s, f_s = stencil_coulomb_energy_forces(sg, q, cutoff, alpha)
    np.testing.assert_allclose(np.asarray(e_s), np.asarray(e_ref),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_ref),
                               rtol=2e-5, atol=2e-6)


def test_stencil_coulomb_nonperiodic():
    # strictly-inside positions: non-periodic binning clamps out-of-box
    # atoms into edge voxels, which would break the occupancy-1 invariant
    rng = np.random.default_rng(7)
    gpts = np.stack(
        np.meshgrid(*([np.arange(6)] * 3), indexing="ij"), -1
    ).reshape(-1, 3) * 3.0 + 1.0
    pos = jnp.asarray(gpts + rng.uniform(-0.2, 0.2, gpts.shape), jnp.float32)
    cell = jnp.asarray(np.eye(3) * 20.0, jnp.float32)
    pbc = np.array([False] * 3)
    cutoff = 6.5
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.normal(size=pos.shape[0]), jnp.float32)

    geo = choose_stencil_geometry(pos, cell, pbc, cutoff)
    assert geo is not None
    dims, radius, origin, _ = geo
    sg = build_stencil_grid(pos, cell, pbc, dims, radius,
                            origin=None if not origin.any() else origin)
    g = build_atom_grid_auto(pos, cell, pbc, cutoff)
    e_ref, f_ref = grid_coulomb_energy_forces(g, q, cutoff, 0.35)
    e_s, f_s = stencil_coulomb_energy_forces(sg, q, cutoff, 0.35)
    np.testing.assert_allclose(np.asarray(e_s), np.asarray(e_ref),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_ref),
                               rtol=2e-5, atol=2e-6)


def test_stencil_f64():
    pos, cell = _crystal(dtype=jnp.float64)
    pbc = np.array([True] * 3)
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.normal(size=pos.shape[0]), jnp.float64)
    sg = build_stencil_auto(pos, cell, pbc, 6.5)
    g = build_atom_grid_auto(pos, cell, pbc, 6.5)
    e_ref, f_ref = grid_coulomb_energy_forces(g, q, 6.5, 0.35)
    e_s, f_s = stencil_coulomb_energy_forces(sg, q, 6.5, 0.35)
    np.testing.assert_allclose(np.asarray(e_s), np.asarray(e_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_ref), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("eng", ["stack", "fuse"])
def test_stack_fullspace_matches_xla_halfspace(eng):
    """Full-space XLA sweeps (stack/fuse) vs the half-space fold, 3 bodies."""
    from nvalchemiops_tpu.stencil import (
        stencil_cn_chain_forces,
        stencil_coordination_numbers,
    )

    pos, cell = _crystal(n_rep=6)
    pbc = np.array([True] * 3)
    cutoff = 6.0
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.normal(size=pos.shape[0]), jnp.float32)
    rcov = jnp.asarray(rng.uniform(0.8, 1.4, pos.shape[0]), jnp.float32)
    decn = jnp.asarray(rng.normal(size=pos.shape[0]), jnp.float32)
    sg = build_stencil_auto(pos, cell, pbc, cutoff)

    e_x, f_x = stencil_coulomb_energy_forces(sg, q, cutoff, 0.35, engine="xla")
    e_s, f_s = stencil_coulomb_energy_forces(sg, q, cutoff, 0.35, engine=eng)
    np.testing.assert_allclose(np.asarray(e_s), np.asarray(e_x),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_x),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(stencil_coordination_numbers(sg, rcov, cutoff,
                                                engine=eng)),
        np.asarray(stencil_coordination_numbers(sg, rcov, cutoff,
                                                engine="xla")),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(stencil_cn_chain_forces(sg, rcov, decn, cutoff,
                                           engine=eng)),
        np.asarray(stencil_cn_chain_forces(sg, rcov, decn, cutoff,
                                           engine="xla")),
        rtol=1e-4, atol=2e-5)


def test_hybrid_d3_matches_xla():
    """grid_dftd3(stencil=...) == engine='xla' to f32 rounding."""
    from nvalchemiops_tpu.grid import build_atom_grid_auto
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        element_cn_ref, grid_dftd3,
    )

    rng = np.random.default_rng(6)
    zmax = 5
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    cn_ref = np.broadcast_to(cna[:, None, :, None],
                             (zmax + 1,) * 2 + (5, 5)).copy()
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

    pos, cell = _crystal()
    pbc = np.array([True] * 3)
    numbers = jnp.asarray(rng.integers(1, zmax + 1, pos.shape[0]), jnp.int32)
    cutoff = 6.5
    cna_j = element_cn_ref(jnp.asarray(cn_ref))
    g = build_atom_grid_auto(pos, cell, pbc, cutoff)
    sg = build_stencil_auto(pos, cell, pbc, cutoff)
    args = (g, numbers, jnp.asarray(rcov), jnp.asarray(r4r2), jnp.asarray(c6),
            cna_j, cutoff, 0.42, 4.1, 1.7)
    e_x, f_x, cn_x = grid_dftd3(*args, engine="xla")
    e_h, f_h, cn_h = grid_dftd3(*args, stencil=sg)
    np.testing.assert_allclose(float(e_h), float(e_x), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cn_h), np.asarray(cn_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(f_h), np.asarray(f_x),
                               rtol=1e-4, atol=1e-6)
