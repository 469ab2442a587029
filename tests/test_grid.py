# SPDX-License-Identifier: Apache-2.0
"""Halo-grid engine tests against the oracle and the matrix-path kernels."""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.grid import (
    build_atom_grid,
    estimate_grid_geometry,
    grid_coordination_numbers,
    grid_coulomb_energy_forces,
    grid_neighbor_count,
)
from nvalchemiops_tpu.neighborlist import naive_neighbor_list
from nvalchemiops_tpu.interactions.electrostatics import coulomb_energy_forces

from tests.neighborlist.oracle import brute_force_neighbors


def make_grid(pos, cell, pbc, cutoff, n, occ=0.4, bins_per_cutoff=1):
    dims, radius, cap = estimate_grid_geometry(
        cell, pbc, cutoff, n, target_occupancy=occ, bins_per_cutoff=bins_per_cutoff
    )
    g = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims, radius, cap)
    assert int(g.counts_max) <= cap, "grid capacity overflow in test setup"
    return g


@pytest.mark.parametrize("pbc", [[True] * 3, [False] * 3, [True, False, True]])
@pytest.mark.parametrize("bins_per_cutoff", [1, 2])
def test_grid_counts_match_oracle(pbc, bins_per_cutoff):
    rng = np.random.default_rng(1)
    cell = np.diag([12.0, 14.0, 11.0])
    pos = rng.uniform(0, 11.0, (300, 3))
    cutoff = 3.2
    g = make_grid(pos, cell, np.array(pbc), cutoff, 300, bins_per_cutoff=bins_per_cutoff)
    counts = np.asarray(grid_neighbor_count(g, cutoff, 300))
    rows = brute_force_neighbors(pos, cutoff, cell, pbc)
    assert np.array_equal(counts, [len(r) for r in rows])


def test_grid_triclinic_counts():
    rng = np.random.default_rng(2)
    cell = np.array([[12.0, 0, 0], [2.0, 11.0, 0], [-1.0, 1.5, 13.0]])
    pos = rng.uniform(0, 1, (250, 3)) @ cell
    cutoff = 3.0
    g = make_grid(pos, cell, np.array([True] * 3), cutoff, 250)
    counts = np.asarray(grid_neighbor_count(g, cutoff, 250))
    rows = brute_force_neighbors(pos, cutoff, cell, [True] * 3)
    assert np.array_equal(counts, [len(r) for r in rows])


def test_grid_unwrapped_positions():
    rng = np.random.default_rng(3)
    cell = np.eye(3) * 12.0
    pos = rng.uniform(0, 12.0, (200, 3)) + np.array([25.0, -13.0, 7.0])
    cutoff = 3.5
    g = make_grid(pos, cell, np.array([True] * 3), cutoff, 200)
    counts = np.asarray(grid_neighbor_count(g, cutoff, 200))
    rows = brute_force_neighbors(pos, cutoff, cell, [True] * 3, extra_margin=5)
    assert np.array_equal(counts, [len(r) for r in rows])


def test_grid_coulomb_matches_matrix_path():
    rng = np.random.default_rng(4)
    cell = np.eye(3) * 12.0
    pos = rng.uniform(0, 12.0, (200, 3))
    q = rng.normal(size=200)
    pbc = np.array([True] * 3)
    cutoff = 3.5
    g = make_grid(pos, cell, pbc, cutoff, 200)
    e, f = grid_coulomb_energy_forces(g, jnp.asarray(q), cutoff, 0.3)
    nm, num, sh = naive_neighbor_list(jnp.asarray(pos), cutoff, pbc=pbc, cell=jnp.asarray(cell))
    e2, f2 = coulomb_energy_forces(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cell), cutoff, 0.3,
        neighbor_matrix=nm, neighbor_matrix_shifts=sh,
    )
    # grid path uses the Abramowitz-Stegun erfc (1.5e-7 abs) by design
    np.testing.assert_allclose(np.asarray(e), np.asarray(e2), atol=5e-6)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f2), atol=5e-6)


def test_grid_coordination_numbers_match_d3():
    from nvalchemiops_tpu.interactions.dispersion import dftd3
    from tests.interactions.dispersion.test_dftd3 import element_tables, A1, A2, S8

    rng = np.random.default_rng(5)
    cell = np.eye(3) * 10.0
    pos = rng.uniform(0, 10.0, (150, 3))
    numbers = rng.integers(1, 6, 150).astype(np.int32)
    params = element_tables()
    cutoff = 3.0
    pbc = np.array([True] * 3)
    nm, num, sh = naive_neighbor_list(jnp.asarray(pos), cutoff, pbc=pbc, cell=jnp.asarray(cell))
    _, _, cn_ref = dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), A1, A2, S8,
        d3_params=params, cell=jnp.asarray(cell),
        neighbor_matrix=nm, neighbor_matrix_shifts=sh, output_dtype=None,
    )
    g = make_grid(pos, cell, pbc, cutoff, 150)
    rcov_per_atom = params.rcov[jnp.asarray(numbers)]
    cn = grid_coordination_numbers(g, rcov_per_atom, cutoff)
    np.testing.assert_allclose(np.asarray(cn), np.asarray(cn_ref), rtol=1e-10)


def test_grid_dftd3_matches_matrix_path():
    from nvalchemiops_tpu.interactions.dispersion import dftd3, D3Parameters
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        element_cn_ref, grid_dftd3,
    )

    rng = np.random.default_rng(6)
    zmax = 5
    # element-structured tables (cn_ref[zi, zj, p, q] = cnA[zi, p])
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    cn_ref = np.broadcast_to(cna[:, None, :, None], (zmax + 1,) * 2 + (5, 5)).copy()
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    # per-element reference availability (real D3 tables: a reference
    # compound exists for an element or it doesn't -> separable zero mask)
    avail = rng.random((zmax + 1, 5)) < 0.8
    avail[:, 0] = True
    avail[0] = False
    c6 *= avail[:, None, :, None] & avail[None, :, None, :]
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    params = D3Parameters(rcov=rcov, r4r2=r4r2, c6ab=c6, cn_ref=cn_ref)

    cell = np.eye(3) * 11.0
    pos = rng.uniform(0, 11.0, (180, 3))
    numbers = rng.integers(1, zmax + 1, 180).astype(np.int32)
    cutoff = 3.4
    pbc = np.array([True] * 3)
    a1, a2, s8 = 0.42, 4.1, 1.7

    nm, num, sh = naive_neighbor_list(
        jnp.asarray(pos), cutoff, pbc=pbc, cell=jnp.asarray(cell)
    )
    e_ref, f_ref, cn_ref_out = dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), a1, a2, s8,
        d3_params=params, cell=jnp.asarray(cell),
        neighbor_matrix=nm, neighbor_matrix_shifts=sh, output_dtype=None,
    )

    g = make_grid(pos, cell, pbc, cutoff, 180)
    cna_j = element_cn_ref(jnp.asarray(cn_ref))
    e_g, f_g, cn_g = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov), jnp.asarray(r4r2),
        jnp.asarray(c6), cna_j, cutoff, a1, a2, s8,
    )
    np.testing.assert_allclose(np.asarray(cn_g), np.asarray(cn_ref_out), rtol=1e-10)
    np.testing.assert_allclose(float(e_g), float(e_ref.sum()), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(f_g), np.asarray(f_ref), rtol=1e-8, atol=1e-12)


def test_grid_dftd3_virial_matches_matrix_path():
    from nvalchemiops_tpu.interactions.dispersion import dftd3, D3Parameters
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        element_cn_ref, grid_dftd3,
    )

    rng = np.random.default_rng(13)
    zmax = 4
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
    params = D3Parameters(rcov=rcov, r4r2=r4r2, c6ab=c6, cn_ref=cn_ref)

    cell = np.eye(3) * 11.0
    pos = rng.uniform(0, 11.0, (150, 3))
    numbers = rng.integers(1, zmax + 1, 150).astype(np.int32)
    cutoff = 3.4
    pbc = np.array([True] * 3)
    a1, a2, s8 = 0.42, 4.1, 1.7

    nm, num, sh = naive_neighbor_list(
        jnp.asarray(pos), cutoff, pbc=pbc, cell=jnp.asarray(cell))
    e_ref, f_ref, cn_r, vir_ref = dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), a1, a2, s8,
        d3_params=params, cell=jnp.asarray(cell),
        neighbor_matrix=nm, neighbor_matrix_shifts=sh, output_dtype=None,
        compute_virial=True,
    )

    g = make_grid(pos, cell, pbc, cutoff, 150)
    cna_j = element_cn_ref(jnp.asarray(cn_ref))
    e_g, f_g, cn_g, vir_g = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov), jnp.asarray(r4r2),
        jnp.asarray(c6), cna_j, cutoff, a1, a2, s8, compute_virial=True,
    )
    np.testing.assert_allclose(float(e_g), float(e_ref.sum()), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(vir_g),
                               np.asarray(vir_ref).reshape(3, 3),
                               rtol=1e-6, atol=1e-8)


def test_batch_grid_dftd3_matches_per_system():
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3, grid_dftd3,
    )
    from nvalchemiops_tpu.grid import build_atom_grid, estimate_grid_geometry

    rng = np.random.default_rng(17)
    B, npa, box, cutoff = 3, 180, 13.0, 4.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    pbc = np.array([True] * 3)
    zmax = 4
    numbers = jnp.asarray(rng.integers(1, zmax + 1, (B, npa)), jnp.int32)
    rcov = jnp.asarray(np.r_[0.0, rng.uniform(0.6, 1.4, zmax)], jnp.float32)
    r4r2 = jnp.asarray(np.r_[0.0, rng.uniform(2.0, 6.0, zmax)], jnp.float32)
    cna = jnp.asarray(
        np.vstack([np.zeros(5),
                   np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)]),
        jnp.float32)
    c6 = rng.uniform(5.0, 40.0, (zmax + 1,) * 2 + (5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = jnp.asarray(0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3)),
                     jnp.float32)

    e_b, f_b, cn_b = batch_grid_dftd3(
        pos, numbers, cell, pbc, cutoff, rcov, r4r2, c6, cna, 0.42, 4.1, 1.7,
        target_occupancy=0.4)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff, npa,
                                               target_occupancy=0.4)
    for b in range(B):
        g = build_atom_grid(pos[b], cell, pbc, dims, radius, cap)
        e1, f1, cn1 = grid_dftd3(g, numbers[b], rcov, r4r2, c6, cna,
                                 cutoff, 0.42, 4.1, 1.7, engine="xla")
        np.testing.assert_allclose(float(e_b[b]), float(e1), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(f_b[b]), np.asarray(f1),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(cn_b[b]), np.asarray(cn1),
                                   atol=1e-6)


def test_element_cn_ref_rejects_general_tables():
    rng = np.random.default_rng(7)
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import element_cn_ref

    bad = rng.uniform(0, 1, (4, 4, 5, 5))
    with pytest.raises(ValueError):
        element_cn_ref(jnp.asarray(bad))


def _toy_d3_tables(rng, zmax=4):
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, cna, c6


@pytest.mark.parametrize(
    "dims,radius,cap",
    [((3, 3, 3), (1, 1, 1), 48),    # capacity far above the occupancy
     ((3, 3, 3), (1, 1, 1), 90),
     ((3, 3, 6), (1, 1, 2), 24)],   # x binned at half the cutoff
    ids=["cap48", "cap90", "xfine"])
def test_grid_xla_forced_geometry_matches_matrix_path(dims, radius, cap):
    """Grid D3 + Coulomb at forced capacities and an x-refined partition
    equal the matrix-path kernels on a naive neighbor matrix."""
    from nvalchemiops_tpu.grid import build_atom_grid
    from nvalchemiops_tpu.interactions.dispersion import D3Parameters, dftd3
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import grid_dftd3

    rng = np.random.default_rng(17)
    rcov, r4r2, cna, c6 = _toy_d3_tables(rng)
    cn_ref_full = np.broadcast_to(cna[:, None, :, None], c6.shape).copy()
    params = D3Parameters(rcov=rcov, r4r2=r4r2, c6ab=c6, cn_ref=cn_ref_full)

    cell = np.eye(3) * 9.0
    n = 140
    pos = rng.uniform(0, 9.0, (n, 3))
    numbers = rng.integers(1, 5, n).astype(np.int32)
    q = rng.normal(size=n)
    pbc = np.array([True] * 3)
    cutoff = 3.0
    g = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims,
                        radius, cap)
    assert int(g.counts_max) <= cap
    e_g, f_g, cn_g = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov), jnp.asarray(r4r2),
        jnp.asarray(c6), jnp.asarray(cna), cutoff, 0.42, 4.1, 1.7)

    nm, _num, sh = naive_neighbor_list(jnp.asarray(pos), cutoff, pbc=pbc,
                                       cell=jnp.asarray(cell))
    e_m, f_m, cn_m = dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), 0.42, 4.1, 1.7,
        d3_params=params, cell=jnp.asarray(cell), neighbor_matrix=nm,
        neighbor_matrix_shifts=sh, output_dtype=None)
    np.testing.assert_allclose(np.asarray(cn_g), np.asarray(cn_m), rtol=1e-10)
    np.testing.assert_allclose(float(e_g), float(jnp.sum(e_m)), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(f_g), np.asarray(f_m), rtol=1e-8,
                               atol=1e-12)

    e_c, f_c = grid_coulomb_energy_forces(g, jnp.asarray(q), cutoff, 0.4)
    e_cm, f_cm = coulomb_energy_forces(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cell), cutoff, 0.4,
        neighbor_matrix=nm, neighbor_matrix_shifts=sh)
    # the grid uses the Abramowitz-Stegun erfc (1.5e-7 abs) by design
    np.testing.assert_allclose(np.asarray(e_c), np.asarray(e_cm), atol=5e-6)
    np.testing.assert_allclose(np.asarray(f_c), np.asarray(f_cm), atol=5e-6)


def test_grid_origin_shift_preserves_results():
    """Any bin-partition origin is a valid partition: same counts, same physics."""
    from nvalchemiops_tpu.grid import choose_grid_origin

    rng = np.random.default_rng(8)
    cell = np.eye(3) * 12.0
    # near-crystalline: lattice planes on bin boundaries (worst case origin=0)
    base = np.stack(np.meshgrid(*[np.arange(6) * 2.0] * 3, indexing="ij"), -1)
    pos = base.reshape(-1, 3) + rng.normal(scale=0.05, size=(216, 3))
    q = rng.normal(size=216).astype(np.float32)
    pbc = np.array([True] * 3)
    cutoff = 3.5
    n = 216
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff, n,
                                               target_occupancy=0.4)
    origin_np, occ = choose_grid_origin(jnp.asarray(pos), cell, pbc, dims)
    g0 = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims, radius, cap)
    g1 = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims, radius, cap,
                         origin=jnp.asarray(origin_np, jnp.float32))
    assert occ <= int(g0.counts_max)
    assert int(g1.counts_max) == occ
    c0 = np.asarray(grid_neighbor_count(g0, cutoff, n))
    c1 = np.asarray(grid_neighbor_count(g1, cutoff, n))
    assert np.array_equal(c0, c1)
    e0, f0 = grid_coulomb_energy_forces(g0, jnp.asarray(q), cutoff, 0.3)
    e1, f1 = grid_coulomb_energy_forces(g1, jnp.asarray(q), cutoff, 0.3)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0), atol=1e-5)


@pytest.mark.parametrize("alpha,ccut", [(0.0, 3.2), (0.35, 2.8)])
def test_grid_dftd3_coulomb_fused_matches_separate(alpha, ccut):
    """The fused D3+Coulomb sweep must equal the two separate calls."""
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        grid_dftd3, grid_dftd3_coulomb,
    )

    rng = np.random.default_rng(9)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

    cell = np.eye(3) * 10.0
    pos = rng.uniform(0, 10.0, (120, 3))
    numbers = rng.integers(1, zmax + 1, 120).astype(np.int32)
    q = rng.normal(size=120).astype(np.float32)
    pbc = np.array([True] * 3)
    cutoff = 3.2
    g = make_grid(pos, cell, pbc, cutoff, 120)
    tables = (jnp.asarray(numbers), jnp.asarray(rcov, jnp.float32),
              jnp.asarray(r4r2, jnp.float32), jnp.asarray(c6, jnp.float32),
              jnp.asarray(cna, jnp.float32))
    e_d, f_d, cn_d, e_c, f_c = grid_dftd3_coulomb(
        g, tables[0], jnp.asarray(q), *tables[1:], cutoff, 0.42, 4.1, 1.7,
        coulomb_cutoff=ccut, alpha=alpha,
    )
    e_ref, f_ref, cn_ref = grid_dftd3(g, *tables, cutoff, 0.42, 4.1, 1.7)
    ec_ref, fc_ref = grid_coulomb_energy_forces(g, jnp.asarray(q), ccut, alpha)
    np.testing.assert_allclose(float(e_d), float(e_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f_d), np.asarray(f_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(cn_d), np.asarray(cn_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(e_c), np.asarray(ec_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_c), np.asarray(fc_ref), atol=1e-5)

    # combine_forces: same per-channel energies, summed force planes,
    # trailing f_coulomb None
    e_d2, f_t, cn2, e_c2, f_none = grid_dftd3_coulomb(
        g, tables[0], jnp.asarray(q), *tables[1:], cutoff, 0.42, 4.1,
        1.7, coulomb_cutoff=ccut, alpha=alpha,
        combine_forces=True,
    )
    assert f_none is None
    np.testing.assert_allclose(float(e_d2), float(e_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cn2), np.asarray(cn_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(e_c2), np.asarray(ec_ref),
                               atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(f_t), np.asarray(f_ref) + np.asarray(fc_ref),
        atol=1e-5)


@pytest.mark.parametrize("cap", [16, 40])
def test_grid_coulomb_matches_matrix_path_at_cap(cap):
    """Slab-periodic grid Coulomb at two capacities == neighbor matrix."""
    rng = np.random.default_rng(5)
    cell = np.eye(3) * 12.0
    pos = rng.uniform(0, 12.0, (150, 3))
    q = rng.normal(size=150)
    pbc = np.array([True, True, False])
    dims, radius, _ = estimate_grid_geometry(cell, pbc, 3.5, 150,
                                             target_occupancy=0.4)
    g = build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc, dims,
                        radius, cap)
    assert int(g.counts_max) <= cap
    nm, _num, sh = naive_neighbor_list(jnp.asarray(pos), 3.5, pbc=pbc,
                                       cell=jnp.asarray(cell))
    for alpha in (0.0, 0.4):
        e_g, f_g = grid_coulomb_energy_forces(g, jnp.asarray(q), 3.5, alpha)
        e_m, f_m = coulomb_energy_forces(
            jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cell), 3.5, alpha,
            neighbor_matrix=nm, neighbor_matrix_shifts=sh)
        np.testing.assert_allclose(np.asarray(e_g), np.asarray(e_m),
                                   atol=5e-6)
        np.testing.assert_allclose(np.asarray(f_g), np.asarray(f_m),
                                   atol=5e-6)


def test_grid_auto_nonperiodic_lumpy_occupancy():
    """Regression: choose_grid_origin once measured occupancy with an
    unconditional periodic wrap while the build clamps on non-PBC axes;
    the undersized capacity silently dropped atoms (missing pairs)."""
    from nvalchemiops_tpu.grid import build_atom_grid_auto, grid_coulomb_energy_forces

    rng = np.random.default_rng(7)
    gpts = np.stack(
        np.meshgrid(*([np.arange(6)] * 3), indexing="ij"), -1
    ).reshape(-1, 3) * 3.0 + 1.0
    pos_np = gpts + rng.uniform(-0.2, 0.2, gpts.shape)
    pos = jnp.asarray(pos_np, jnp.float64)
    cell = jnp.asarray(np.eye(3) * 20.0, jnp.float64)
    pbc = np.array([False] * 3)
    cutoff = 6.5
    q_np = rng.normal(size=len(pos_np))

    d = pos_np[None, :, :] - pos_np[:, None, :]
    r = np.sqrt((d**2).sum(-1))
    np.fill_diagonal(r, np.inf)
    mask = r < cutoff
    e_bf = 0.5 * (q_np[:, None] * q_np[None, :] / r * mask).sum(1)

    g = build_atom_grid_auto(pos, cell, pbc, cutoff)
    assert int(g.counts_max) <= g.cap
    e_g, _ = grid_coulomb_energy_forces(g, jnp.asarray(q_np, jnp.float64),
                                        cutoff, 0.0)
    np.testing.assert_allclose(np.asarray(e_g), e_bf, rtol=1e-10, atol=1e-12)


def test_grid_d3_quad_bilinear_bitwise_matches_split():
    """bilinear="quad" stacks pass-2's three dots into one quadrant dot.

    Both layouts compute the same dot products, so the energy plane must
    be BIT-identical.
    """
    from nvalchemiops_tpu.grid import _extend_like, scatter_to_grid
    from nvalchemiops_tpu.interactions.dispersion import grid_d3 as gd3

    rng = np.random.default_rng(23)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate(
        [np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

    cell = np.eye(3) * 10.0
    pos = rng.uniform(0, 10.0, (80, 3))
    numbers = rng.integers(1, zmax + 1, 80).astype(np.int32)
    g = make_grid(pos, cell, np.array([True] * 3), 3.2, 80)

    mesh, zmax1 = 5, zmax + 1
    numbers_j = jnp.asarray(numbers)
    mask_a = gd3.element_c6_mask(jnp.asarray(c6, jnp.float32))[numbers_j]
    mask_a = mask_a.astype(jnp.float32)
    c6p = jnp.transpose(jnp.asarray(c6, jnp.float32),
                        (0, 2, 1, 3)).reshape(zmax1, mesh, zmax1 * mesh)

    z_plane = scatter_to_grid(g, numbers_j, fill=0)
    rcov_plane = scatter_to_grid(g, jnp.asarray(rcov[numbers], jnp.float32))
    r4r2_plane = scatter_to_grid(g, jnp.asarray(r4r2[numbers], jnp.float32))

    def run(bilinear):
        return gd3._grid_d3_impl(
            g, z_plane, _extend_like(g, z_plane, 0),
            rcov_plane, _extend_like(g, rcov_plane, 0.0),
            r4r2_plane, _extend_like(g, r4r2_plane, 0.0),
            jnp.asarray(cna, jnp.float32)[numbers_j], mask_a, c6p[numbers_j],
            3.2, 0.42, 4.1, 1.7, 1.8, 16.0, -4.0,
            g.dims, g.radius, g.cap, mesh, zmax1, bilinear=bilinear,
        )

    out_s = run("split")
    out_q = run("quad")
    for a, b in zip(out_s, out_q):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_compact_d3_elements_matches_full_tables():
    """Compacted present-element tables reproduce the full-table results."""
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        compact_d3_elements, element_cn_ref, grid_dftd3,
    )
    from nvalchemiops_tpu.interactions.dispersion.dense_d3 import dense_dftd3

    rng = np.random.default_rng(23)
    zmax = 40  # big sparse table; only a handful of elements present
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate(
        [np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cn_ref_full = np.broadcast_to(
        cna[:, None, :, None], (zmax + 1,) * 2 + (5, 5)).copy()

    cell = np.eye(3) * 11.0
    pos = rng.uniform(0, 11.0, (160, 3))
    present = np.array([3, 7, 29, 40])
    numbers = present[rng.integers(0, len(present), 160)].astype(np.int32)
    cutoff = 3.4
    pbc = np.array([True] * 3)
    a1, a2, s8 = 0.42, 4.1, 1.7

    nums_c, rcov_c, r4r2_c, c6_c, cn_c = compact_d3_elements(
        jnp.asarray(numbers), jnp.asarray(rcov), jnp.asarray(r4r2),
        jnp.asarray(c6), jnp.asarray(cn_ref_full))
    assert int(jnp.max(nums_c)) == len(present)
    assert c6_c.shape == (5, 5, 5, 5)

    g = make_grid(pos, cell, pbc, cutoff, 160)
    e_f, f_f, cn_f = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov), jnp.asarray(r4r2),
        jnp.asarray(c6), element_cn_ref(jnp.asarray(cn_ref_full)),
        cutoff, a1, a2, s8)
    e_c, f_c, cn_cc = grid_dftd3(
        g, nums_c, rcov_c, r4r2_c, c6_c, element_cn_ref(cn_c),
        cutoff, a1, a2, s8)
    np.testing.assert_allclose(float(e_c), float(e_f), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f_c), np.asarray(f_f),
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(np.asarray(cn_cc), np.asarray(cn_f), rtol=1e-6)

    # dense minimum-image path through the same compaction
    e_df, f_df, cn_df = dense_dftd3(
        jnp.asarray(pos, jnp.float32), jnp.asarray(numbers),
        jnp.asarray(cell, jnp.float32), cutoff,
        jnp.asarray(rcov, jnp.float32), jnp.asarray(r4r2, jnp.float32),
        jnp.asarray(c6, jnp.float32), jnp.asarray(cna, jnp.float32),
        a1, a2, s8)
    e_dc, f_dc, cn_dc = dense_dftd3(
        jnp.asarray(pos, jnp.float32), nums_c,
        jnp.asarray(cell, jnp.float32), cutoff,
        rcov_c.astype(jnp.float32), r4r2_c.astype(jnp.float32),
        c6_c.astype(jnp.float32), element_cn_ref(cn_c).astype(jnp.float32),
        a1, a2, s8)
    np.testing.assert_allclose(float(e_dc), float(e_df), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(f_dc), np.asarray(f_df),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cn_dc), np.asarray(cn_df),
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["stack", "bf16", "stack_bf16"])
def test_grid_dftd3_bilinear_variants_match_split(variant):
    """The lhs-stacked einsum computes the same dot products as the split
    form; bf16 feature storage only re-rounds the einsum operands."""
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import grid_dftd3

    rng = np.random.default_rng(23)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate(
        [np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

    cell = np.eye(3) * 10.0
    pos = rng.uniform(0, 10.0, (100, 3))
    numbers = rng.integers(1, zmax + 1, 100).astype(np.int32)
    pbc = np.array([True] * 3)
    g = make_grid(pos, cell, pbc, 3.2, 100)
    args = (
        g, jnp.asarray(numbers), jnp.asarray(rcov, jnp.float32),
        jnp.asarray(r4r2, jnp.float32), jnp.asarray(c6, jnp.float32),
        jnp.asarray(cna, jnp.float32), 3.2, 0.42, 4.1, 1.7,
    )
    e_s, f_s, cn_s = grid_dftd3(*args, bilinear="split")
    kw = {}
    if "stack" in variant:
        kw["bilinear"] = "stack"
    if "bf16" in variant:
        kw["feature_dtype"] = jnp.bfloat16
    e_v, f_v, cn_v = grid_dftd3(*args, **kw)
    if "bf16" in variant:
        # storage re-rounding only: documented engine-level tolerance
        np.testing.assert_allclose(float(e_v), float(e_s), rtol=2e-3)
        np.testing.assert_allclose(np.asarray(f_v), np.asarray(f_s),
                                   atol=5e-3)
    else:
        np.testing.assert_allclose(float(e_v), float(e_s), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(f_v), np.asarray(f_s),
                                   atol=1e-12)
    np.testing.assert_allclose(np.asarray(cn_v), np.asarray(cn_s),
                               atol=1e-12)


def test_choose_grid_geometry_valid_and_consistent():
    """Every searched geometry is a valid partition: the picked one must
    reproduce the estimate_grid_geometry physics exactly."""
    from nvalchemiops_tpu.grid import (
        build_atom_grid, build_atom_grid_auto, choose_grid_geometry,
        grid_coulomb_energy_forces,
    )

    rng = np.random.default_rng(17)
    # incommensurate near-crystal: 7 lattice planes, bins won't divide evenly
    base = np.stack(
        np.meshgrid(*[np.arange(7) * 1.9] * 3, indexing="ij"), -1
    ).reshape(-1, 3)
    pos = base + rng.uniform(-0.15, 0.15, base.shape)
    box = 7 * 1.9
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    pbc = np.array([True] * 3)
    pos_j = jnp.asarray(pos, jnp.float32)
    cutoff = 4.0
    q = jnp.asarray(rng.normal(size=len(pos)), jnp.float32)

    dims, radius, cap, origin = choose_grid_geometry(pos_j, cell, pbc, cutoff)
    assert all(r <= d for r, d in zip(radius, dims))
    g_best = build_atom_grid_auto(pos_j, cell, pbc, cutoff,
                                  optimize_geometry=True)
    assert int(g_best.counts_max) <= g_best.cap

    g_ref = build_atom_grid_auto(pos_j, cell, pbc, cutoff)
    e_a, f_a = grid_coulomb_energy_forces(g_best, q, cutoff, 0.3)
    e_b, f_b = grid_coulomb_energy_forces(g_ref, q, cutoff, 0.3)
    np.testing.assert_allclose(np.asarray(e_a), np.asarray(e_b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f_b), atol=1e-4)


def test_choose_grid_geometry_minimizes_row_sweep_slots():
    """The pick has the fewest row-sweep slots among the searched dims."""
    from nvalchemiops_tpu.grid import (
        choose_grid_geometry, choose_grid_origin, row_sweep_slots,
    )

    rng = np.random.default_rng(19)
    base = np.stack(
        np.meshgrid(*[np.arange(8) * 2.0] * 3, indexing="ij"), -1
    ).reshape(-1, 3)
    pos = jnp.asarray(base + rng.uniform(-0.1, 0.1, base.shape), jnp.float32)
    cell = jnp.asarray(np.eye(3) * 16.0, jnp.float32)
    pbc = np.array([True] * 3)
    cutoff = 3.9
    alternatives = [(4, 4, 4), (4, 4, 8), (8, 8, 8), (3, 3, 3)]
    dims, radius, cap, _origin = choose_grid_geometry(
        pos, cell, pbc, cutoff, dims_candidates=alternatives)
    best = row_sweep_slots(dims, radius, cap)
    for alt in alternatives:
        alt_radius = tuple(int(np.ceil(cutoff * d / 16.0)) for d in alt)
        _, occ = choose_grid_origin(pos, cell, pbc, alt)
        alt_cap = max(int(np.ceil((occ + 1) / 8)) * 8,
                      int(np.ceil(occ * 1.02 / 8)) * 8)
        assert best <= row_sweep_slots(alt, alt_radius, alt_cap), alt
    # the slot formula itself: own-row band plus full windows elsewhere
    assert row_sweep_slots((2, 3, 4), (1, 1, 1), 8) == 24 * 64 * (2 + 4 * 3)


def test_grid_dftd3_coulomb_xla_engine_matches_separate():
    """Fused xla-engine D3+Coulomb == separate grid_dftd3 + grid Coulomb."""
    from nvalchemiops_tpu.grid import grid_coulomb_energy_forces
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        grid_dftd3, grid_dftd3_coulomb,
    )

    rng = np.random.default_rng(31)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate(
        [np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

    cell = np.eye(3) * 10.0
    pos = rng.uniform(0, 10.0, (120, 3))
    numbers = rng.integers(1, zmax + 1, 120).astype(np.int32)
    q = rng.normal(size=120)
    pbc = np.array([True] * 3)
    g = make_grid(pos, cell, pbc, 3.2, 120)
    args = (
        g, jnp.asarray(numbers), jnp.asarray(q, jnp.float32),
        jnp.asarray(rcov, jnp.float32), jnp.asarray(r4r2, jnp.float32),
        jnp.asarray(c6, jnp.float32), jnp.asarray(cna, jnp.float32),
        3.2, 0.42, 4.1, 1.7,
    )
    e_f, f_f, cn_f, ec_f, fc_f = grid_dftd3_coulomb(
        *args, alpha=0.35, engine="xla")
    e_s, f_s, cn_s = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov, jnp.float32),
        jnp.asarray(r4r2, jnp.float32), jnp.asarray(c6, jnp.float32),
        jnp.asarray(cna, jnp.float32), 3.2, 0.42, 4.1, 1.7, engine="xla")
    ec_s, fc_s = grid_coulomb_energy_forces(
        g, jnp.asarray(q, jnp.float32), 3.2, 0.35)
    np.testing.assert_allclose(float(e_f), float(e_s), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f_f), np.asarray(f_s), atol=1e-6)
    np.testing.assert_allclose(np.asarray(cn_f), np.asarray(cn_s), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ec_f), np.asarray(ec_s), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fc_f), np.asarray(fc_s), atol=1e-5)


@pytest.mark.parametrize("pbc", [[True, False, True], [False] * 3])
def test_grid_dftd3_mixed_pbc_matches_matrix_path(pbc):
    """Grid D3 on slab/cluster boundary conditions == matrix-path dftd3."""
    from nvalchemiops_tpu.interactions.dispersion import D3Parameters, dftd3
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import grid_dftd3
    from nvalchemiops_tpu.neighborlist import naive_neighbor_list

    rng = np.random.default_rng(41)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cnA = np.concatenate(
        [np.zeros((1, 5)), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cn_ref_full = np.broadcast_to(cnA[:, None, :, None], c6.shape).copy()

    cell = np.eye(3) * 9.0
    pos = rng.uniform(0.5, 8.5, (90, 3))
    numbers = rng.integers(1, zmax + 1, 90).astype(np.int32)
    pbc_arr = np.array(pbc)
    cutoff = 3.0

    g = make_grid(pos, cell, pbc_arr, cutoff, 90)
    e_g, f_g, cn_g = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov, jnp.float32),
        jnp.asarray(r4r2, jnp.float32), jnp.asarray(c6, jnp.float32),
        jnp.asarray(cnA, jnp.float32), cutoff, 0.42, 4.1, 1.7)

    params = D3Parameters(rcov=rcov, r4r2=r4r2, c6ab=c6,
                          cn_ref=cn_ref_full)
    if pbc_arr.any():
        nm, _num, sh = naive_neighbor_list(
            jnp.asarray(pos, jnp.float32), cutoff,
            cell=jnp.asarray(cell, jnp.float32), pbc=pbc_arr)
        e_m, f_m, cn_m = dftd3(
            jnp.asarray(pos, jnp.float32), jnp.asarray(numbers),
            0.42, 4.1, 1.7, d3_params=params,
            cell=jnp.asarray(cell, jnp.float32),
            neighbor_matrix=nm, neighbor_matrix_shifts=sh)
    else:
        nm, _num = naive_neighbor_list(jnp.asarray(pos, jnp.float32), cutoff)
        e_m, f_m, cn_m = dftd3(
            jnp.asarray(pos, jnp.float32), jnp.asarray(numbers),
            0.42, 4.1, 1.7, d3_params=params, neighbor_matrix=nm)
    np.testing.assert_allclose(float(e_g), float(jnp.sum(e_m)), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(cn_g), np.asarray(cn_m), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_g), np.asarray(f_m), atol=1e-4)


@pytest.mark.parametrize("pbc", [[True] * 3, [True, False, True]])
@pytest.mark.parametrize("shared_cell", [True, False])
def test_batch_build_matches_vmapped_single(pbc, shared_cell):
    """batch_build_atom_grid is field-for-field == jax.vmap(build_atom_grid).

    The fused builder exists purely for performance (one global
    compound-key sort instead of a batched sort), so its contract is
    bit-identical output.
    """
    import jax
    from nvalchemiops_tpu.grid import batch_build_atom_grid

    rng = np.random.default_rng(17)
    B, npa = 3, 120
    cell0 = np.diag([11.0, 12.0, 10.0])
    if shared_cell:
        cells = np.broadcast_to(cell0, (B, 3, 3)).copy()
        cells_arg = jnp.asarray(cell0, jnp.float32)
    else:
        cells = np.stack([cell0 * (1.0 + 0.05 * b) for b in range(B)])
        cells_arg = jnp.asarray(cells, jnp.float32)
    pos = np.stack([rng.uniform(0, 10.0, (npa, 3)) for _ in range(B)])
    pbc_arr = np.array(pbc)
    dims, radius, cap = estimate_grid_geometry(
        cell0, pbc_arr, 3.0, npa, target_occupancy=0.4)

    pos_j = jnp.asarray(pos, jnp.float32)
    g_b = batch_build_atom_grid(pos_j, cells_arg, pbc_arr, dims, radius, cap)
    g_v = jax.vmap(
        lambda p, c: build_atom_grid(p, c, pbc_arr, dims, radius, cap)
    )(pos_j, jnp.asarray(cells, jnp.float32))

    for f in ("ext_px", "ext_py", "ext_pz", "ext_valid", "ext_aid",
              "ext_shift_code", "flat_slot", "counts_max"):
        a, b = np.asarray(getattr(g_b, f)), np.asarray(getattr(g_v, f))
        np.testing.assert_array_equal(a, b, err_msg=f)

    # and the batched grid drives per-system kernels through vmap
    counts_b = jax.vmap(lambda g: grid_neighbor_count(g, 3.0, npa))(g_b)
    for b in range(B):
        rows = brute_force_neighbors(pos[b], 3.0, cells[b], pbc)
        assert np.array_equal(np.asarray(counts_b[b]),
                              [len(r) for r in rows]), b
