# SPDX-License-Identifier: Apache-2.0
"""Windowed spread/gather vs the dense separable reference path.

The tile-windowed formulation (spline_windowed.py) must agree with the
dense path (spline.py) to roundoff for every supported order, non-cubic
meshes, tiny single-tile meshes, and positions outside the box.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.spline import (
    spline_gather,
    spline_gather_gradient,
    spline_spread,
)
from nvalchemiops_tpu.spline_windowed import (
    build_mesh_tiles,
    mesh_tile_capacity,
    windowed_applicable,
    windowed_gather,
    windowed_spread,
)


@pytest.mark.parametrize(
    "dims,order,n",
    [
        ((16, 16, 16), 4, 300),
        ((8, 16, 24), 3, 117),
        ((8, 8, 8), 4, 40),
        ((16, 16, 16), 2, 100),
        ((16, 16, 16), 1, 100),
    ],
)
def test_windowed_matches_dense(dims, order, n):
    rng = np.random.default_rng(3)
    cell = jnp.asarray(np.diag(rng.uniform(8, 14, 3)), jnp.float64)
    pos = jnp.asarray(rng.uniform(-5, 20, (n, 3)), jnp.float64)  # incl. out-of-box
    q = jnp.asarray(rng.normal(size=n), jnp.float64)

    assert windowed_applicable(dims, order)
    cap = mesh_tile_capacity(n, dims)
    tiles = build_mesh_tiles(pos, cell, dims, order, cap)
    assert int(tiles.counts_max) <= cap

    mesh_w = windowed_spread(tiles, q)
    mesh_d = spline_spread(pos, q, cell, dims, spline_order=order)
    np.testing.assert_allclose(np.asarray(mesh_w), np.asarray(mesh_d), atol=1e-12)

    phi = jnp.asarray(rng.normal(size=dims), jnp.float64)
    v_w, g_w = windowed_gather(tiles, phi, with_gradient=True)
    v_d = spline_gather(pos, phi, cell, spline_order=order)
    f_d = spline_gather_gradient(pos, q, phi, cell, spline_order=order)
    f_w = (-q[:, None] * g_w) @ tiles.inv.T
    np.testing.assert_allclose(np.asarray(v_w), np.asarray(v_d), atol=1e-12)
    np.testing.assert_allclose(np.asarray(f_w), np.asarray(f_d), atol=1e-10)


def test_overflow_falls_back_to_dense():
    """Public spread path must stay correct when one tile overflows."""
    rng = np.random.default_rng(0)
    dims = (16, 16, 16)
    n = 200
    cell = jnp.asarray(np.eye(3) * 10.0, jnp.float64)
    # all atoms clustered inside one mesh tile -> guaranteed overflow
    pos = jnp.asarray(rng.uniform(0.0, 0.3, (n, 3)), jnp.float64)
    q = jnp.asarray(rng.normal(size=n), jnp.float64)

    cap = mesh_tile_capacity(n, dims)
    tiles = build_mesh_tiles(pos, cell, dims, 4, cap)
    assert int(tiles.counts_max) > cap  # the fixture really overflows

    mesh = spline_spread(pos, q, cell, dims, spline_order=4)
    np.testing.assert_allclose(float(mesh.sum()), float(q.sum()), rtol=1e-12)
    # gather of a smooth field still exact vs direct evaluation shape
    phi = jnp.asarray(rng.normal(size=dims), jnp.float64)
    v = spline_gather(pos, phi, cell, spline_order=4)
    assert v.shape == (n,)
    assert np.isfinite(np.asarray(v)).all()


@pytest.mark.parametrize("clustered", [False, True],
                         ids=["windowed", "overflow"])
def test_spline_gather_128_mesh_matches_windowed(clustered):
    """Public single-system gather at a 128^3 mesh == the windowed gather.

    The clustered case overflows one tile, so the public path takes its
    dense separable-matmul branch; both branches are compiled either way.
    """
    import nvalchemiops_tpu.spline_windowed as sw

    rng = np.random.default_rng(21)
    dims, n, box = (128, 128, 128), 96, 40.0
    lo, hi = (0.0, 0.2) if clustered else (0.0, box)
    pos = jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)
    q = jnp.asarray(rng.normal(size=n), jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    phi = jnp.asarray(rng.normal(size=dims), jnp.float32)

    tiles = sw.build_mesh_tiles(pos, cell, dims, 4, n, need_grad=True)
    v_w, g_w = sw.windowed_gather(tiles, phi, with_gradient=True)
    f_w = (-q[:, None] * g_w) @ tiles.inv.T
    overflow = int(tiles.counts_max) > sw.mesh_tile_capacity(n, dims)
    assert overflow == clustered

    v = spline_gather(pos, phi, cell, spline_order=4)
    f = spline_gather_gradient(pos, q, phi, cell, spline_order=4)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_w),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_w),
                               rtol=1e-4, atol=1e-4)


def test_refresh_mesh_tiles_and_rebuild_detector():
    """Cached-binning refresh == full rebuild while atoms stay in their
    tiles; the detector flags a tile crossing (MD-loop skin analogue)."""
    import nvalchemiops_tpu.spline_windowed as sw

    rng = np.random.default_rng(11)
    n, box = 500, 12.0
    dims = (16, 16, 16)
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float64)
    cell = jnp.asarray(np.eye(3) * box, jnp.float64)
    q = jnp.asarray(rng.normal(size=n), jnp.float64)
    cap = sw.mesh_tile_capacity(n, dims)
    tiles = sw.build_mesh_tiles(pos, cell, dims, 4, cap, need_grad=True)

    assert not bool(sw.mesh_tiles_need_rebuild(tiles, pos))

    # nudge atoms by much less than a tile width: binning unchanged
    # (tile = 8 mesh points = 6 A here; 1e-3 A cannot cross for atoms
    # not already on a boundary -- use a nudge toward the tile center)
    mesh_per_len = dims[0] / box
    frac_in_tile = (np.asarray(pos) * mesh_per_len) % 8.0
    safe = jnp.asarray(((frac_in_tile > 0.2) & (frac_in_tile < 7.3))
                       .all(axis=1))
    delta = jnp.where(safe[:, None], 1e-3, 0.0)
    pos2 = pos + delta
    assert not bool(sw.mesh_tiles_need_rebuild(tiles, pos2))

    fresh = sw.build_mesh_tiles(pos2, cell, dims, 4, cap, need_grad=True)
    refreshed = sw.refresh_mesh_tiles(tiles, pos2)
    # same binning => same slots; spread/gather agree with full rebuild
    mesh_f = sw.windowed_spread(fresh, q)
    mesh_r = sw.windowed_spread(refreshed, q)
    np.testing.assert_allclose(np.asarray(mesh_r), np.asarray(mesh_f),
                               atol=1e-12)
    phi = jnp.asarray(rng.normal(size=dims), jnp.float64)
    vf, gf = sw.windowed_gather(fresh, phi, with_gradient=True)
    vr, gr = sw.windowed_gather(refreshed, phi, with_gradient=True)
    np.testing.assert_allclose(np.asarray(vr), np.asarray(vf), atol=1e-12)
    np.testing.assert_allclose(np.asarray(gr), np.asarray(gf), atol=1e-12)

    # move one atom a full tile: the detector must fire
    pos3 = np.array(pos)
    pos3[7] = (pos3[7] + box / 2.0) % box
    assert bool(sw.mesh_tiles_need_rebuild(tiles, jnp.asarray(pos3)))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_stencil_weights_match_bspline_basis(order):
    """The local-parameter stencil weights equal M(u), dM/du at u_i."""
    from nvalchemiops_tpu.spline import (
        bspline_derivative, bspline_grid_offset, bspline_weight,
        stencil_weights,
    )

    theta = jnp.asarray(np.r_[0.0, 0.25, 0.5 - 1e-12, 0.5, 0.77, 1 - 1e-12],
                        jnp.float64)
    w, dw = stencil_weights(theta, order)
    start = bspline_grid_offset(0, order, theta[:, None])[:, 0]
    i = np.arange(order)
    u = order / 2 + np.asarray(theta)[:, None] - (i[None] + np.asarray(start)[:, None])
    np.testing.assert_allclose(np.asarray(w),
                               np.asarray(bspline_weight(jnp.asarray(u), order)),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(dw),
                               np.asarray(bspline_derivative(jnp.asarray(u), order)),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(w).sum(-1), 1.0, atol=1e-12)
