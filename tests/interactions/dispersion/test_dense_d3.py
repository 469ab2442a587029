# SPDX-License-Identifier: Apache-2.0
"""Dense minimum-image D3 vs the grid engine, incl. batching + padding."""

import numpy as np
import jax.numpy as jnp

from nvalchemiops_tpu.grid import build_atom_grid, estimate_grid_geometry
from nvalchemiops_tpu.interactions.dispersion.dense_d3 import (
    batch_dense_dftd3,
    dense_dftd3,
)
from nvalchemiops_tpu.interactions.dispersion.grid_d3 import grid_dftd3


def _tables(rng, zmax=4):
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
    return rcov, r4r2, c6, cna


def test_dense_matches_grid_with_padding():
    rng = np.random.default_rng(0)
    npa, box, cutoff = 260, 14.0, 4.0
    pos = jnp.asarray(rng.uniform(0, box, (npa, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    pbc = np.array([True] * 3)
    zmax = 4
    numbers = jnp.asarray(
        np.r_[rng.integers(1, zmax + 1, npa - 12), np.zeros(12)].astype(
            np.int32))
    rcov, r4r2, c6, cna = _tables(rng, zmax)

    e_d, f_d, cn_d = dense_dftd3(pos, numbers, cell, cutoff, rcov, r4r2,
                                 c6, cna, 0.42, 4.1, 1.7)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff, npa,
                                               target_occupancy=0.4)
    g = build_atom_grid(pos, cell, pbc, dims, radius, cap)
    e_g, f_g, cn_g = grid_dftd3(g, numbers, rcov, r4r2, c6, cna, cutoff,
                                0.42, 4.1, 1.7, engine="xla")
    np.testing.assert_allclose(float(e_d), float(e_g), rtol=2e-6)
    np.testing.assert_allclose(np.asarray(cn_d), np.asarray(cn_g), atol=2e-5)
    np.testing.assert_allclose(np.asarray(f_d), np.asarray(f_g), atol=2e-5)
    # padding atoms carry no force
    assert np.abs(np.asarray(f_d)[-12:]).max() == 0.0


def test_dense_images_beyond_minimum_image():
    """cutoff in (width/2, width): the 8-combo image sweep vs the matrix
    path (full shift enumeration) — the reference's 21.2 A batched config
    shape, where minimum image alone misses boundary-shell pairs."""
    import pytest

    from nvalchemiops_tpu.interactions.dispersion import dftd3
    from nvalchemiops_tpu.neighborlist import naive_neighbor_list

    rng = np.random.default_rng(3)
    npa, box, cutoff = 60, 8.0, 6.3  # cutoff/width = 0.79
    pos64 = rng.uniform(0, box, (npa, 3))
    cell64 = np.eye(3) * box
    zmax = 4
    numbers = jnp.asarray(rng.integers(1, zmax + 1, npa), jnp.int32)
    rcov, r4r2, c6, cna = _tables(rng, zmax)

    pos = jnp.asarray(pos64, jnp.float64)
    cell = jnp.asarray(cell64, jnp.float64)
    e_d, f_d, cn_d = dense_dftd3(pos, numbers, cell, cutoff,
                                 rcov, r4r2, c6, cna, 0.42, 4.1, 1.7)

    # oracle: matrix path with full periodic-shift enumeration
    nm, num, sh = naive_neighbor_list(pos, cutoff, pbc=np.array([True] * 3),
                                      cell=cell, max_neighbors=512)
    # build element-shaped cn_ref from the element table for the oracle
    cn_ref = jnp.broadcast_to(
        jnp.asarray(cna)[:, None, :, None],
        (zmax + 1, zmax + 1, 5, 5)).astype(jnp.float64)
    e_m, f_m, cn_m = dftd3(
        pos, numbers, 0.42, 4.1, 1.7,
        covalent_radii=jnp.asarray(rcov, jnp.float64),
        r4r2=jnp.asarray(r4r2, jnp.float64),
        c6_reference=jnp.asarray(c6, jnp.float64), coord_num_ref=cn_ref,
        cell=cell, neighbor_matrix=nm, neighbor_matrix_shifts=sh,
        output_dtype=None)
    np.testing.assert_allclose(np.asarray(cn_d), np.asarray(cn_m),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(e_d), float(jnp.sum(e_m)), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(f_d), np.asarray(f_m), atol=1e-9)

    # minimum image alone must NOT match (shell pairs exist) — guards the
    # auto-switch from silently being a no-op in this regime
    e_mi, _, _ = dense_dftd3(pos, numbers, cell, cutoff, rcov, r4r2, c6,
                             cna, 0.42, 4.1, 1.7, images=False)
    assert abs(float(e_mi) - float(jnp.sum(e_m))) > 1e-9

    # cutoff >= width is rejected
    with pytest.raises(ValueError, match="min cell width"):
        dense_dftd3(pos, numbers, cell, 8.5, rcov, r4r2, c6, cna,
                    0.42, 4.1, 1.7)


def test_image_combo_pruning():
    """Distance-pruned combo list: only combos whose minimal image
    distance can beat the cutoff survive (exact for orthogonal cells)."""
    from nvalchemiops_tpu.interactions.dispersion.dense_d3 import (
        _image_combos,
    )

    cell = np.eye(3) * 41.2
    # reference batched config: cutoff/width = 0.514 -> sqrt(2)*20.6 > 21.2
    # kills every multi-axis combo; 4 survive
    combos = _image_combos(True, cell, 21.2)
    assert sorted(combos) == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0)]
    # cutoff/width = 0.79 -> two-axis combos live, the corner dies
    combos = _image_combos(True, np.eye(3) * 8.0, 6.3)
    assert (1, 1, 1) not in combos and len(combos) == 7
    # near the width bound everything survives
    assert len(_image_combos(True, np.eye(3) * 8.0, 7.9)) == 8
    # no concrete cell: conservative full set
    assert len(_image_combos(True)) == 8
    # triclinic falls back to the per-axis max bound (conservative):
    # a 45-degree sheared cell keeps multi-axis combos that the orthogonal
    # sum rule would kill
    tric = np.array([[8.0, 0, 0], [4.0, 8.0, 0], [0, 0, 8.0]])
    combos_t = _image_combos(True, tric, 6.3)
    assert (0, 0, 0) in combos_t
    for bits in combos_t:
        assert all(b in (0, 1) for b in bits)


def test_dense_images_shell_regime_pruned_combos():
    """cutoff just over width/2 (the benchmark's 0.514 ratio): the pruned
    4-combo sweep still matches the full-shift matrix oracle."""
    from nvalchemiops_tpu.interactions.dispersion import dftd3
    from nvalchemiops_tpu.neighborlist import naive_neighbor_list

    rng = np.random.default_rng(7)
    npa, box = 70, 9.0
    cutoff = 4.63  # ratio 0.514, the reference batched-benchmark shape
    pos64 = rng.uniform(0, box, (npa, 3))
    cell64 = np.eye(3) * box
    zmax = 4
    numbers = jnp.asarray(rng.integers(1, zmax + 1, npa), jnp.int32)
    rcov, r4r2, c6, cna = _tables(rng, zmax)

    from nvalchemiops_tpu.interactions.dispersion.dense_d3 import (
        _image_combos,
    )
    assert len(_image_combos(True, cell64, cutoff)) == 4

    pos = jnp.asarray(pos64, jnp.float64)
    cell = jnp.asarray(cell64, jnp.float64)
    e_d, f_d, cn_d = dense_dftd3(pos, numbers, cell, cutoff,
                                 rcov, r4r2, c6, cna, 0.42, 4.1, 1.7)

    nm, num, sh = naive_neighbor_list(pos, cutoff, pbc=np.array([True] * 3),
                                      cell=cell, max_neighbors=256)
    cn_ref = jnp.broadcast_to(
        jnp.asarray(cna)[:, None, :, None],
        (zmax + 1, zmax + 1, 5, 5)).astype(jnp.float64)
    e_m, f_m, cn_m = dftd3(
        pos, numbers, 0.42, 4.1, 1.7,
        covalent_radii=jnp.asarray(rcov, jnp.float64),
        r4r2=jnp.asarray(r4r2, jnp.float64),
        c6_reference=jnp.asarray(c6, jnp.float64), coord_num_ref=cn_ref,
        cell=cell, neighbor_matrix=nm, neighbor_matrix_shifts=sh,
        output_dtype=None)
    np.testing.assert_allclose(np.asarray(cn_d), np.asarray(cn_m),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(e_d), float(jnp.sum(e_m)), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(f_d), np.asarray(f_m), atol=1e-9)


def test_batch_dense_matches_per_system():
    rng = np.random.default_rng(1)
    B, npa, box, cutoff = 3, 150, 12.0, 4.0
    pos = jnp.asarray(rng.uniform(0, box, (B, npa, 3)), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    zmax = 4
    numbers = jnp.asarray(rng.integers(1, zmax + 1, (B, npa)), jnp.int32)
    rcov, r4r2, c6, cna = _tables(rng, zmax)

    e_b, f_b, cn_b = batch_dense_dftd3(pos, numbers, cell, cutoff, rcov,
                                       r4r2, c6, cna, 0.42, 4.1, 1.7)
    for b in range(B):
        e1, f1, cn1 = dense_dftd3(pos[b], numbers[b], cell, cutoff, rcov,
                                  r4r2, c6, cna, 0.42, 4.1, 1.7)
        np.testing.assert_allclose(float(e_b[b]), float(e1), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(f_b[b]), np.asarray(f1),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(cn_b[b]), np.asarray(cn1),
                                   atol=1e-6)


def test_batch_dftd3_router():
    """Unified batch router: dense for small systems, grid at scale /
    mixed pbc, dense when the grid can't represent the cutoff."""
    import pytest
    import numpy as np
    import jax.numpy as jnp
    from nvalchemiops_tpu.interactions.dispersion import batch_dftd3
    from nvalchemiops_tpu.interactions.dispersion.dense_d3 import (
        batch_dense_dftd3,
    )
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3,
    )

    rng = np.random.default_rng(3)
    zmax = 4
    rcov = jnp.asarray(np.r_[0, rng.uniform(0.6, 1.2, zmax)], jnp.float64)
    r4r2 = jnp.asarray(np.r_[0, rng.uniform(2, 5, zmax)], jnp.float64)
    cna = jnp.asarray(np.vstack(
        [np.zeros(5), np.cumsum(rng.uniform(0.3, 1, (zmax, 5)), 1)]),
        jnp.float64)
    c6_np = rng.uniform(5, 40, (zmax + 1, zmax + 1, 5, 5))
    c6_np[0] = 0
    c6_np[:, 0] = 0
    c6_np = 0.5 * (c6_np + np.swapaxes(np.swapaxes(c6_np, 0, 1), 2, 3))
    c6 = jnp.asarray(c6_np, jnp.float64)
    B, n = 2, 96
    box = 12.0
    pos = jnp.asarray(rng.uniform(0, box, (B, n, 3)))
    numbers = jnp.asarray(rng.integers(1, zmax + 1, (B, n)), jnp.int32)
    cell = jnp.asarray(np.eye(3) * box)
    pbc = np.array([True] * 3)
    args = (3.4, rcov, r4r2, c6, cna, 0.42, 4.1, 1.7)

    # small all-PBC -> dense; equals the dense engine exactly
    e_a, f_a, cn_a = batch_dftd3(pos, numbers, cell, pbc, *args)
    e_d, f_d, cn_d = batch_dense_dftd3(pos, numbers, cell, *args)
    np.testing.assert_array_equal(np.asarray(e_a), np.asarray(e_d))

    # mixed pbc -> grid; equals the grid engine exactly
    pbc_mix = np.array([True, False, True])
    e_m, f_m, cn_m = batch_dftd3(pos, numbers, cell, pbc_mix, *args)
    e_g, f_g, cn_g = batch_grid_dftd3(pos, numbers, cell, pbc_mix, *args)
    np.testing.assert_array_equal(np.asarray(e_m), np.asarray(e_g))
    # and the two engines agree physically on the all-PBC workload
    e_g2, f_g2, _ = batch_grid_dftd3(pos, numbers, cell, pbc, *args)
    np.testing.assert_allclose(np.asarray(e_a), np.asarray(e_g2),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f_g2),
                               atol=1e-9)

    # cutoff beyond the grid bound (radius > cells/dim) -> dense w/ images
    e_big, f_big, _ = batch_dftd3(pos, numbers, cell, pbc, 7.0, rcov,
                                  r4r2, c6, cna, 0.42, 4.1, 1.7)
    e_bd, f_bd, _ = batch_dense_dftd3(pos, numbers, cell, 7.0, rcov,
                                      r4r2, c6, cna, 0.42, 4.1, 1.7)
    np.testing.assert_array_equal(np.asarray(e_big), np.asarray(e_bd))

    with pytest.raises(ValueError):
        batch_dftd3(pos, numbers, cell, pbc_mix, *args, engine="dense")
