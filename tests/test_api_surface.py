# SPDX-License-Identifier: Apache-2.0
"""Direct exercises for public API previously reached only indirectly.

Companion to tests/test_api_reach.py: the batch cell-list
build/query split, the rebuild-detection convenience wrappers, the
shift-packing utilities, the exact-f32 math helpers, and the AtomGrid
scatter/gather round trip each get a small direct test so they leave
the unreached allowlist.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.grid import (
    AtomGrid,
    build_atom_grid,
    estimate_grid_geometry,
    gather_from_grid,
    scatter_to_grid,
)
from nvalchemiops_tpu.mathops import apply_mat3, dot_phases
from nvalchemiops_tpu.neighborlist import (
    BatchCellList,
    CellList,
    batch_build_cell_list,
    batch_query_cell_list,
    build_cell_list,
    check_cell_list_rebuild_needed,
    check_neighbor_list_rebuild_needed,
    estimate_batch_cell_list_sizes,
    estimate_cell_list_sizes,
    query_cell_list,
)
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    pack_shifts,
    shifts_from_aos,
    shifts_to_aos,
    unpack_shifts,
)

from tests.neighborlist.oracle import brute_force_neighbors


def test_shift_packing_roundtrip():
    rng = np.random.default_rng(0)
    s = jnp.asarray(rng.integers(-500, 501, (40, 3)), jnp.int32)
    packed = pack_shifts(s[:, 0], s[:, 1], s[:, 2])
    sx, sy, sz = unpack_shifts(packed)
    np.testing.assert_array_equal(np.asarray(jnp.stack([sx, sy, sz], -1)),
                                  np.asarray(s))
    aos = shifts_to_aos(packed)
    np.testing.assert_array_equal(np.asarray(aos), np.asarray(s))
    np.testing.assert_array_equal(np.asarray(shifts_from_aos(aos)),
                                  np.asarray(packed))


def test_exact_vpu_math_helpers():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((50, 3))
    m = rng.standard_normal((3, 3))
    np.testing.assert_allclose(np.asarray(apply_mat3(jnp.asarray(v),
                                                     jnp.asarray(m))),
                               v @ m, rtol=1e-6, atol=1e-12)
    k = rng.standard_normal((7, 3))
    ph = dot_phases(jnp.asarray(v), jnp.asarray(k))
    np.testing.assert_allclose(np.asarray(ph), v @ k.T, rtol=1e-6,
                               atol=1e-12)


def test_atom_grid_scatter_gather_roundtrip():
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 10.0, (120, 3))
    cell = np.eye(3) * 10.0
    pbc = np.array([True] * 3)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, 3.0, 120,
                                               target_occupancy=0.4)
    g = build_atom_grid(jnp.asarray(pos, jnp.float32),
                        jnp.asarray(cell, jnp.float32), pbc, dims, radius,
                        cap)
    assert isinstance(g, AtomGrid)
    vals = jnp.asarray(rng.standard_normal(120), jnp.float32)
    plane = scatter_to_grid(g, vals)
    back = gather_from_grid(g, plane)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(vals))


def test_cached_cell_list_split_and_rebuild_wrappers():
    rng = np.random.default_rng(3)
    n, box, cutoff = 150, 11.0, 3.1
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    pbc = np.array([True] * 3)
    max_total_cells, radius = estimate_cell_list_sizes(cell, pbc, cutoff, n)
    cl = build_cell_list(pos, cutoff, cell, pbc, max_total_cells, n)
    assert isinstance(cl, CellList)
    cap = int(np.ceil(int(jnp.max(cl.atoms_per_cell_count)) / 8)) * 8
    radius_t = tuple(int(v) for v in np.asarray(radius))
    nm, num, sh = query_cell_list(pos, cutoff, cell, pbc, cl, radius_t,
                                  cap, 48)
    rows = brute_force_neighbors(np.asarray(pos), cutoff, np.asarray(cell),
                                 pbc)
    assert np.array_equal(np.asarray(num), [len(r) for r in rows])

    # rebuild-detection convenience wrappers (reference-parity signature:
    # the full cell-list artifact field set)
    assert not bool(check_cell_list_rebuild_needed(
        *cl, pos, cell, pbc, cutoff))
    moved = pos.at[0].add(jnp.asarray([3.5, 0.0, 0.0], jnp.float32))
    assert bool(check_cell_list_rebuild_needed(
        *cl, moved, cell, pbc, cutoff))
    assert not bool(check_neighbor_list_rebuild_needed(pos, pos, 0.5))
    assert bool(check_neighbor_list_rebuild_needed(pos, moved, 0.5))


def test_batch_cell_list_split():
    rng = np.random.default_rng(4)
    B, npa, box, cutoff = 3, 90, 9.5, 3.0
    pos_np = rng.uniform(0, box, (B * npa, 3))
    pos = jnp.asarray(pos_np, jnp.float32)
    cells = jnp.asarray(np.tile(np.eye(3) * box, (B, 1, 1)), jnp.float32)
    pbc = np.array([True] * 3)
    batch_idx = jnp.asarray(np.repeat(np.arange(B), npa), jnp.int32)
    stride, max_total_cells, radius = estimate_batch_cell_list_sizes(
        cells, pbc, cutoff, npa)
    cl = batch_build_cell_list(pos, cutoff, cells, pbc, batch_idx, stride,
                               npa)
    assert isinstance(cl, BatchCellList)
    cap = int(np.ceil(int(jnp.max(cl.atoms_per_cell_count)) / 8)) * 8
    radius_t = tuple(int(v) for v in np.asarray(radius).max(axis=0))
    nm, num, sh = batch_query_cell_list(pos, cutoff, cells, pbc, batch_idx,
                                        cl, stride, radius_t, cap, 48)
    for b in range(B):
        rows = brute_force_neighbors(pos_np[b * npa:(b + 1) * npa], cutoff,
                                     np.eye(3) * box, pbc)
        np.testing.assert_array_equal(
            np.asarray(num[b * npa:(b + 1) * npa]), [len(r) for r in rows])


def test_parameter_estimators_dataclasses():
    """Kolafa-Perram / PME sizing containers (reference parameters.py)."""
    from nvalchemiops_tpu.interactions.electrostatics import (
        EwaldParameters,
        PMEParameters,
        estimate_ewald_parameters,
        estimate_pme_mesh_dimensions,
        estimate_pme_parameters,
    )

    rng = np.random.default_rng(6)
    n, box = 500, 20.0
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    ew = estimate_ewald_parameters(pos, cell, accuracy=1e-6)
    assert isinstance(ew, EwaldParameters)
    eta = (box**3 * box**3 / n) ** (1 / 6) / np.sqrt(2 * np.pi)
    np.testing.assert_allclose(float(ew.alpha[0]), 1 / (np.sqrt(2) * eta),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ew.real_space_cutoff[0]),
                               np.sqrt(-2 * np.log(1e-6)) * eta, rtol=1e-5)
    pme = estimate_pme_parameters(pos, cell, accuracy=1e-6)
    assert isinstance(pme, PMEParameters)
    dims = estimate_pme_mesh_dimensions(cell, pme.alpha, accuracy=1e-6)
    assert tuple(pme.mesh_dimensions) == tuple(dims)
    # power-of-two mesh, n >= ceil(2 alpha L / (3 eps^(1/5)))
    for d in dims:
        assert d & (d - 1) == 0
        assert d >= 2 * float(pme.alpha[0]) * box / (3 * 1e-6 ** 0.2)


def test_generate_k_vectors_pme_matches_fft_grid():
    from nvalchemiops_tpu.interactions.electrostatics import (
        generate_k_vectors_pme,
    )

    box = (11.0, 13.0, 17.0)
    cell = jnp.asarray(np.diag(box), jnp.float64)
    mesh = (8, 4, 6)
    kv, k2 = generate_k_vectors_pme(cell, mesh)
    assert kv.shape == (8, 4, 4, 3)
    # orthorhombic: k = 2 pi m / L with fftfreq/rfftfreq Miller indices
    mx = np.fft.fftfreq(mesh[0]) * mesh[0]
    kz = np.fft.rfftfreq(mesh[2]) * mesh[2]
    np.testing.assert_allclose(np.asarray(kv)[:, 0, 0, 0],
                               2 * np.pi * mx / box[0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(kv)[0, 0, :, 2],
                               2 * np.pi * kz / box[2], atol=1e-12)
    # k_squared_safe equals |k|^2 away from k = 0 and is positive at 0
    k2_ref = (np.asarray(kv) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(k2).ravel()[1:],
                               k2_ref.ravel()[1:], rtol=1e-12)
    assert float(np.asarray(k2).ravel()[0]) > 0


def test_small_math_and_heuristic_helpers():
    from nvalchemiops_tpu.grid import use_slot_gather
    from nvalchemiops_tpu.mathops import exp_over_x
    from nvalchemiops_tpu.spline import (
        compute_bspline_deconvolution,
        compute_bspline_deconvolution_1d,
    )

    x = jnp.asarray([0.5, 1.0, 2.5])
    np.testing.assert_allclose(np.asarray(exp_over_x(x, 0.7)),
                               np.exp(-0.7 * np.asarray(x)) / np.asarray(x),
                               rtol=1e-7)
    # the 3-D deconvolution factorizes into the 1-D moduli away from the
    # Nyquist sentinel caps (|b(k)|^-2 clamped where the modulus vanishes)
    d3 = np.asarray(compute_bspline_deconvolution((8, 4, 6), 4))
    dx = np.asarray(compute_bspline_deconvolution_1d(8, 4))
    dy = np.asarray(compute_bspline_deconvolution_1d(4, 4))
    dz = np.asarray(compute_bspline_deconvolution_1d(6, 4))
    prod = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
    finite = prod < 1e14
    np.testing.assert_allclose(d3[finite], prod[finite], rtol=1e-10)
    assert (d3[~finite] >= 1e14).all()
    # gather/scatter heuristic: large single systems gather, tiny ones
    # (the vmapped-batch regime) scatter
    assert use_slot_gather(524_288, 700_000)
    assert not use_slot_gather(2_000, 4_000)


def test_mlip_energy_and_batched_forces_direct():
    """parallel.mlip primitives: invariance + forces == -grad."""
    from nvalchemiops_tpu.parallel import (
        default_d3_tables,
        init_mlip_params,
    )
    from nvalchemiops_tpu.parallel.mlip import (
        MLIPParams,
        batched_energy_forces,
        mlip_energy,
    )

    rng = np.random.default_rng(8)
    zmax = 4
    params = init_mlip_params(zmax)
    assert isinstance(params, MLIPParams)
    tables = default_d3_tables(zmax)
    B, npa, box = 2, 24, 8.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)))
    numbers = jnp.asarray(rng.integers(1, zmax + 1, (B, npa)), jnp.int32)
    numbers = numbers.at[1, -4:].set(0)  # padding atoms
    cells = jnp.asarray(np.tile(np.eye(3) * box, (B, 1, 1)))

    e0 = mlip_energy(params, tables, pos[0], numbers[0], cells[0], 3.5)
    # translation invariance (periodic)
    e_t = mlip_energy(params, tables, pos[0] + 1.234, numbers[0],
                      cells[0], 3.5)
    np.testing.assert_allclose(float(e0), float(e_t), rtol=1e-10)

    e_b, f_b = batched_energy_forces(params, tables, pos, numbers, cells,
                                     3.5)
    np.testing.assert_allclose(float(e_b[0]), float(e0), rtol=1e-12)
    # forces == -dE/dr by finite difference on one coordinate
    h = 1e-6
    dp = jnp.zeros_like(pos).at[0, 3, 1].set(h)
    ep = batched_energy_forces(params, tables, pos + dp, numbers, cells,
                               3.5)[0]
    em = batched_energy_forces(params, tables, pos - dp, numbers, cells,
                               3.5)[0]
    fd = -(float(ep[0]) - float(em[0])) / (2 * h)
    np.testing.assert_allclose(float(f_b[0, 3, 1]), fd, rtol=1e-4,
                               atol=1e-8)
    # padding atoms carry zero force
    np.testing.assert_array_equal(np.asarray(f_b[1, -4:]), 0.0)
