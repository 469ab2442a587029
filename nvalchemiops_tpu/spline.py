# SPDX-License-Identifier: Apache-2.0
"""B-spline mesh interpolation (spread / gather / gradients / deconvolution).

JAX counterpart of ``nvalchemiops/spline.py`` (basis functions at
spline.py:126-494, 12 Warp kernels at :496-1330, wrappers at :2581-3190).
Conventions are identical:

- Cardinal B-splines of order 1-4; mesh parameter ``u = order/2 + theta -
  offset`` with ``offset = i + floor(theta - (order-2)/2)`` so ``u`` always
  falls in ``[0, order)`` and the order weights per dimension sum to 1.
- Fractional coords ``s = r @ cell^-1`` (lattice vectors are cell rows),
  periodic index wrapping.
- ``spline_gather_gradient`` returns forces ``F_i = -q_i sum_g phi(g)
  grad w`` with the fractional gradient scaled by mesh dims and rotated to
  Cartesian by ``cell^-1``.

Architecture: the reference launches one thread per (atom, stencil point)
with atomic scatter/gather (spline.py:496-760).  Here the separable stencil
is built as three [N, order] weight/index arrays; gathers are dense
vectorized loads and the spread is one flat ``scatter-add`` over the
``order^3`` outer product — the only scatter in the whole library (it is
also exactly the adjoint of the gather, which keeps ``jax.grad`` exact).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.mathops.math import apply_mat3, mesh_coordinates
from nvalchemiops_tpu.types import INDEX_DTYPE

__all__ = [
    "bspline_weight",
    "bspline_derivative",
    "compute_fractional_coords",
    "stencil_weights",
    "bspline_grid_offset",
    "bspline_weight_3d",
    "bspline_weight_gradient_3d",
    "wrap_grid_index",
    "spline_spread",
    "spline_gather",
    "spline_gather_vec3",
    "spline_gather_gradient",
    "spline_spread_channels",
    "spline_gather_channels",
    "compute_bspline_deconvolution",
    "compute_bspline_deconvolution_1d",
]


# ---------------------------------------------------------------------------
# Basis functions (reference: spline.py:126-255)
# ---------------------------------------------------------------------------


def bspline_weight(u, order: int):
    """Cardinal B-spline basis M_order(u) on [0, order), vectorized."""
    u = jnp.asarray(u)
    zero = jnp.zeros_like(u)
    if order == 1:
        return jnp.where((u >= 0) & (u < 1), jnp.ones_like(u), zero)
    if order == 2:
        return jnp.where(
            (u >= 0) & (u < 1), u, jnp.where((u >= 1) & (u < 2), 2.0 - u, zero)
        )
    if order == 3:
        w0 = 0.5 * u * u
        w1 = 0.75 - (u - 1.5) ** 2
        w2 = 0.5 * (3.0 - u) ** 2
        return jnp.where(
            (u >= 0) & (u < 1), w0,
            jnp.where((u >= 1) & (u < 2), w1, jnp.where((u >= 2) & (u < 3), w2, zero)),
        )
    if order == 4:
        w0 = u**3 / 6.0
        w1 = (-3.0 * u**3 + 12.0 * u**2 - 12.0 * u + 4.0) / 6.0
        w2 = (3.0 * u**3 - 24.0 * u**2 + 60.0 * u - 44.0) / 6.0
        w3 = (4.0 - u) ** 3 / 6.0
        return jnp.where(
            (u >= 0) & (u < 1), w0,
            jnp.where(
                (u >= 1) & (u < 2), w1,
                jnp.where((u >= 2) & (u < 3), w2, jnp.where((u >= 3) & (u < 4), w3, zero)),
            ),
        )
    raise ValueError(f"spline order must be 1-4, got {order}")


def bspline_derivative(u, order: int):
    """dM_order/du, vectorized (reference: spline.py:196-255)."""
    u = jnp.asarray(u)
    zero = jnp.zeros_like(u)
    if order == 1:
        return zero
    if order == 2:
        return jnp.where(
            (u >= 0) & (u < 1), jnp.ones_like(u),
            jnp.where((u >= 1) & (u < 2), -jnp.ones_like(u), zero),
        )
    if order == 3:
        return jnp.where(
            (u >= 0) & (u < 1), u,
            jnp.where(
                (u >= 1) & (u < 2), -2.0 * (u - 1.5),
                jnp.where((u >= 2) & (u < 3), -(3.0 - u), zero),
            ),
        )
    if order == 4:
        d0 = 0.5 * u * u
        d1 = (-9.0 * u**2 + 24.0 * u - 12.0) / 6.0
        d2 = (9.0 * u**2 - 48.0 * u + 60.0) / 6.0
        d3 = -0.5 * (4.0 - u) ** 2
        return jnp.where(
            (u >= 0) & (u < 1), d0,
            jnp.where(
                (u >= 1) & (u < 2), d1,
                jnp.where((u >= 2) & (u < 3), d2, jnp.where((u >= 3) & (u < 4), d3, zero)),
            ),
        )
    raise ValueError(f"spline order must be 1-4, got {order}")


# ---------------------------------------------------------------------------
# Low-level stencil helpers (reference: spline.py:257-494), vectorized.
#
# These are the public building blocks the reference exposes for kernel
# authors; the library's own spread/gather paths use the separable stencil
# below instead (same math, batched per axis).
# ---------------------------------------------------------------------------


def compute_fractional_coords(positions, cell, mesh_dims, batch_idx=None):
    """Mesh coordinates of each atom (reference: spline.py:257-302).

    Returns ``(base_grid, theta)``: the floor of the mesh-scaled fractional
    coordinate as int32 ``[..., 3]`` and its fractional remainder in
    ``[0, 1)`` with the dtype of ``positions``.
    """
    positions = jnp.asarray(positions)
    frac, _ = _cell_inverse_per_atom(positions, jnp.asarray(cell, positions.dtype),
                                     batch_idx)
    mesh_coords = frac * jnp.asarray(mesh_dims, positions.dtype)
    base = jnp.floor(mesh_coords)
    return base.astype(INDEX_DTYPE), mesh_coords - base


def bspline_grid_offset(point_idx, order: int, theta):
    """Grid offset of linear stencil point(s) (reference: spline.py:304-349).

    ``point_idx`` enumerates the ``order**3`` cube points; the returned
    ``[..., 3]`` int32 offset includes the ``floor(theta - (order-2)/2)``
    start shift that keeps the spline parameter ``u`` inside ``[0, order)``.
    """
    point_idx = jnp.asarray(point_idx, INDEX_DTYPE)
    theta = jnp.asarray(theta)
    i = point_idx // (order * order)
    j = (point_idx % (order * order)) // order
    k = point_idx % order
    ijk = jnp.stack(jnp.broadcast_arrays(i, j, k), axis=-1)
    start = jnp.floor(theta - 0.5 * (order - 2)).astype(INDEX_DTYPE)
    return ijk + start


def _spline_u(theta, offset, order: int):
    theta = jnp.asarray(theta)
    return 0.5 * order + theta - jnp.asarray(offset).astype(theta.dtype)


def stencil_weights(theta, order: int):
    """B-spline weights and d/du derivatives of the ``order`` stencil points.

    ``theta`` ``[...]`` is the fractional mesh coordinate in ``[0, 1)``;
    point ``i`` sits at grid offset ``i + floor(theta - (order-2)/2)`` (the
    convention of :func:`bspline_grid_offset`) with spline parameter
    ``u_i = (order - 1 - i) + t``.  The basis pieces are evaluated in the
    local ``t`` (``theta``, or ``theta -+ 0.5`` for odd orders) in a
    cancellation-free form: the ``u`` polynomials of :func:`bspline_weight`
    cancel terms of size ~200 near ``u = 3`` and lose ~5 digits in float32.
    Returns ``(w, dw)`` of shape ``[..., order]`` (point axis last).
    """
    theta = jnp.asarray(theta)
    if order % 2:
        t = jnp.where(theta < 0.5, theta + 0.5, theta - 0.5)
    else:
        t = theta
    s = 1.0 - t
    if order == 1:
        pieces = [(jnp.ones_like(t), jnp.zeros_like(t))]
    elif order == 2:
        pieces = [(t, jnp.ones_like(t)), (s, -jnp.ones_like(t))]
    elif order == 3:
        pieces = [(0.5 * t * t, t),
                  (0.75 - (t - 0.5) ** 2, 1.0 - 2.0 * t),
                  (0.5 * s * s, -s)]
    elif order == 4:
        pieces = [(t * t * t / 6.0, 0.5 * t * t),
                  ((1.0 + t * (3.0 + t * (3.0 - 3.0 * t))) / 6.0,
                   0.5 * (1.0 + 3.0 * t) * s),
                  ((4.0 + t * t * (3.0 * t - 6.0)) / 6.0,
                   0.5 * t * (3.0 * t - 4.0)),
                  (s * s * s / 6.0, -0.5 * s * s)]
    else:
        raise ValueError(f"spline order must be 1-4, got {order}")
    # point i uses piece order - 1 - i
    w = jnp.stack([pieces[order - 1 - i][0] for i in range(order)], axis=-1)
    dw = jnp.stack([pieces[order - 1 - i][1] for i in range(order)], axis=-1)
    return w, dw


def bspline_weight_3d(theta, offset, order: int):
    """Separable 3-D spline weight ``M(u_x) M(u_y) M(u_z)``
    (reference: spline.py:350-408); zero outside ``u in [0, order)``."""
    u = _spline_u(theta, offset, order)
    return (bspline_weight(u[..., 0], order)
            * bspline_weight(u[..., 1], order)
            * bspline_weight(u[..., 2], order))


def bspline_weight_gradient_3d(theta, offset, order: int, mesh_dims):
    """Gradient of :func:`bspline_weight_3d` w.r.t. ``theta``, scaled by
    ``mesh_dims`` (reference: spline.py:410-483)."""
    u = _spline_u(theta, offset, order)
    dims = jnp.asarray(mesh_dims, u.dtype)
    wx = bspline_weight(u[..., 0], order)
    wy = bspline_weight(u[..., 1], order)
    wz = bspline_weight(u[..., 2], order)
    dwx = bspline_derivative(u[..., 0], order) * dims[0]
    dwy = bspline_derivative(u[..., 1], order) * dims[1]
    dwz = bspline_derivative(u[..., 2], order) * dims[2]
    return jnp.stack([dwx * wy * wz, wx * dwy * wz, wx * wy * dwz], axis=-1)


def wrap_grid_index(idx, dim):
    """Periodic grid-index wrap (reference: spline.py:485-488).

    ``jnp.mod`` already returns a value in ``[0, dim)`` for positive
    ``dim``, matching the reference's double-mod spelling.
    """
    return jnp.mod(jnp.asarray(idx, INDEX_DTYPE), dim)


# ---------------------------------------------------------------------------
# Separable stencil construction
# ---------------------------------------------------------------------------


def _cell_inverse_per_atom(positions, cell, batch_idx):
    """Fractional coordinates s = r @ cell^-1 per atom."""
    dtype = positions.dtype
    inv = jnp.linalg.inv(jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3))
    if batch_idx is not None and inv.shape[0] > 1:
        inv_a = inv[batch_idx.astype(INDEX_DTYPE)]
        frac = sum(positions[:, d:d + 1] * inv_a[:, d] for d in range(3))
        return frac, inv
    return apply_mat3(positions, inv[0]), inv


def _stencil(positions, cell, mesh_dims, order: int, batch_idx):
    """Per-atom separable stencil.

    Returns (gidx [N,3,order] wrapped int indices, w [N,3,order] weights,
    dw [N,3,order] derivative weights scaled by mesh dims, cell_inv [B,3,3]).
    """
    dtype = positions.dtype
    dims = jnp.asarray(mesh_dims, dtype=INDEX_DTYPE)
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    inv = jnp.linalg.inv(cell_b)
    if batch_idx is not None and inv.shape[0] > 1:
        b_of = batch_idx.astype(INDEX_DTYPE)
        cell_a, inv_a = cell_b[b_of], inv[b_of]
    else:
        cell_a, inv_a = cell_b[0], inv[0]
    base, theta = mesh_coordinates(positions, tuple(mesh_dims), cell=cell_a,
                                   inv=inv_a)

    i = jnp.arange(order, dtype=INDEX_DTYPE)  # [order]
    offset_start = jnp.floor(theta - (order - 2) * 0.5).astype(INDEX_DTYPE)  # [N,3]
    offset = i[None, None, :] + offset_start[..., None]  # [N,3,order]
    w, dw = stencil_weights(theta, order)
    dw = dw * dims.astype(dtype)[None, :, None]

    g = base[..., None] + offset
    gidx = jnp.mod(g, dims[None, :, None])  # periodic wrap
    return gidx, w, dw, inv


def _flat_indices(gidx, mesh_dims, batch_idx, num_systems):
    """Flattened order^3 mesh indices per atom: [N, order^3]."""
    nx, ny, nz = mesh_dims
    gx = gidx[:, 0, :, None, None]
    gy = gidx[:, 1, None, :, None]
    gz = gidx[:, 2, None, None, :]
    flat = (gx * ny + gy) * nz + gz  # [N, o, o, o]
    n = gidx.shape[0]
    order = gidx.shape[2]
    flat = flat.reshape(n, order**3)
    if batch_idx is not None and num_systems > 1:
        flat = flat + batch_idx.astype(INDEX_DTYPE)[:, None] * (nx * ny * nz)
    return flat


# ---------------------------------------------------------------------------
# Separable one-hot matmul formulation
# ---------------------------------------------------------------------------
#
# Instead of a scatter/gather of one element per (atom, stencil point), the
# separable B-spline stencil is expressed as three dense per-axis weight
# matrices contracted as matmuls:
#
#   S_x[n, gx] = sum_i w_x[n, i] * [gx == gidx_x[n, i]]      (dense [N, nx])
#   mesh[x, y, z] = sum_n (q S_x)[n, x] S_y[n, y] S_z[n, z]
#
# evaluated as chunked matmuls (~N * nx * ny * nz flops).  Interpolation (gather) and gradients are the same
# contractions transposed / with derivative weights.


def _axis_weight_matrix(gidx_d, w_d, n_mesh: int):
    """Dense per-axis spread matrix [N, n_mesh] from stencil indices/weights."""
    mesh_iota = jax.lax.broadcasted_iota(INDEX_DTYPE, (1, 1, n_mesh), 2)
    onehot = (gidx_d[:, :, None] == mesh_iota).astype(w_d.dtype)
    return jnp.einsum("nio,ni->no", onehot, w_d,
                      precision=jax.lax.Precision.HIGHEST)


def _separable_spread(values, sx, sy, sz, chunk: int = 2048):
    """mesh[x,y,z] = sum_n values[n] sx[n,x] sy[n,y] sz[n,z] via chunked matmul."""
    n = values.shape[0]
    nx, ny, nz = sx.shape[1], sy.shape[1], sz.shape[1]
    dtype = values.dtype
    num_chunks = max(1, -(-n // chunk))
    n_pad = num_chunks * chunk
    qx = jnp.pad(values[:, None] * sx, ((0, n_pad - n), (0, 0)))
    syp = jnp.pad(sy, ((0, n_pad - n), (0, 0)))
    szp = jnp.pad(sz, ((0, n_pad - n), (0, 0)))

    def body(mesh, c):
        zero = jnp.zeros((), INDEX_DTYPE)
        a = jax.lax.dynamic_slice(qx, (c, zero), (chunk, nx))
        b = jax.lax.dynamic_slice(syp, (c, zero), (chunk, ny))
        d = jax.lax.dynamic_slice(szp, (c, zero), (chunk, nz))
        t = jnp.einsum("ny,nz->nyz", b, d,
                       precision=jax.lax.Precision.HIGHEST).reshape(chunk, ny * nz)
        mesh = mesh + jnp.einsum("nx,nm->xm", a, t,
                                 precision=jax.lax.Precision.HIGHEST
                                 ).reshape(nx, ny, nz)
        return mesh, None

    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * chunk
    mesh, _ = jax.lax.scan(body, jnp.zeros((nx, ny, nz), dtype), starts)
    return mesh


def dense_spread_single(positions, values, cell, mesh_dims,
                        spline_order: int = 4):
    """Separable-matmul spread for ONE system, no tile machinery.

    Bypasses the tile-windowed auto-select inside :func:`spline_spread`:
    for small meshes under vmap (the batched-PME shape) the windowed
    path's per-tile [cap, W^3] expansion dominates, while this is one
    [n, ny*nz] intermediate + one contraction.
    """
    mats, _ = _stencil_axis_matrices(positions, cell, tuple(mesh_dims),
                                     spline_order, None)
    return _separable_spread(values, *mats)


def dense_gather_single(positions, mesh, cell, spline_order: int = 4):
    """Separable-matmul scalar gather for one system (see
    :func:`dense_spread_single`)."""
    (sx, sy, sz), _ = _stencil_axis_matrices(
        positions, cell, tuple(mesh.shape[-3:]), spline_order, None)
    return _separable_gather(mesh, sx, sy, sz)


def dense_gather_gradient_single(positions, charges, mesh, cell,
                                 spline_order: int = 4):
    """Separable-matmul gradient gather (force convention of
    :func:`spline_gather_gradient`) for one system."""
    dims = tuple(mesh.shape[-3:])
    f_comps = []
    inv = None
    for d in range(3):
        (sx, sy, sz), inv = _stencil_axis_matrices(
            positions, cell, dims, spline_order, None, derivative_axis=d)
        f_comps.append(-charges * _separable_gather(mesh, sx, sy, sz))
    f_frac = jnp.stack(f_comps, axis=-1)
    return apply_mat3(f_frac, inv[0].T)


def _separable_gather(mesh, sx, sy, sz, chunk: int = 2048):
    """out[n] = sum_xyz mesh[x,y,z] sx[n,x] sy[n,y] sz[n,z] via chunked matmul."""
    n = sx.shape[0]
    nx, ny, nz = sx.shape[1], sy.shape[1], sz.shape[1]
    num_chunks = max(1, -(-n // chunk))
    n_pad = num_chunks * chunk
    sxp = jnp.pad(sx, ((0, n_pad - n), (0, 0)))
    syp = jnp.pad(sy, ((0, n_pad - n), (0, 0)))
    szp = jnp.pad(sz, ((0, n_pad - n), (0, 0)))
    mesh2 = mesh.reshape(nx, ny * nz)

    def body(_, c):
        zero = jnp.zeros((), INDEX_DTYPE)
        a = jax.lax.dynamic_slice(sxp, (c, zero), (chunk, nx))
        b = jax.lax.dynamic_slice(syp, (c, zero), (chunk, ny))
        d = jax.lax.dynamic_slice(szp, (c, zero), (chunk, nz))
        t = jnp.einsum("nx,xm->nm", a, mesh2,
                       precision=jax.lax.Precision.HIGHEST).reshape(chunk, ny, nz)
        out = jnp.einsum("nyz,ny,nz->n", t, b, d,
                         precision=jax.lax.Precision.HIGHEST)
        return None, out

    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * chunk
    _, out = jax.lax.scan(body, None, starts)
    return out.reshape(n_pad)[:n]


def _stencil_axis_matrices(positions, cell, mesh_dims, order, batch_idx,
                           derivative_axis: int | None = None):
    """Per-axis dense spread matrices (optionally with d/du on one axis)."""
    gidx, w, dw, inv = _stencil(positions, cell, mesh_dims, order, batch_idx)
    mats = []
    for d in range(3):
        wd = dw[:, d] if derivative_axis == d else w[:, d]
        mats.append(_axis_weight_matrix(gidx[:, d], wd, int(mesh_dims[d])))
    return mats, inv


# ---------------------------------------------------------------------------
# Public spread / gather (reference: spline.py:2581-2786)
# ---------------------------------------------------------------------------


def _num_systems(cell, batch_idx):
    cell_arr = jnp.asarray(cell)
    if cell_arr.ndim == 3 and cell_arr.shape[0] > 1:
        return cell_arr.shape[0]
    if batch_idx is None:
        return 1
    if isinstance(batch_idx, jax.core.Tracer):
        raise ValueError(
            "Under jit, pass a batched cell [num_systems, 3, 3] so the "
            "system count is static (batch_idx values are traced)."
        )
    return int(jax.device_get(jnp.max(batch_idx))) + 1


@partial(jax.jit, static_argnames=("mesh_dims", "spline_order", "num_systems", "channels"))
def _spread_impl(positions, values, cell, batch_idx, mesh_dims, spline_order, num_systems, channels):
    dtype = positions.dtype
    nx, ny, nz = mesh_dims

    if batch_idx is None and num_systems == 1:
        from nvalchemiops_tpu import spline_windowed as sw

        def dense(_):
            mats, _u = _stencil_axis_matrices(positions, cell, mesh_dims, spline_order, None)
            sx, sy, sz = mats
            if channels:
                c = values.shape[1]
                return jnp.stack(
                    [_separable_spread(values[:, ci], sx, sy, sz) for ci in range(c)],
                    axis=0,
                )
            return _separable_spread(values, sx, sy, sz)

        if sw.windowed_applicable(mesh_dims, spline_order):
            # tile-windowed fast path; dense fallback on tile overflow
            cap = sw.mesh_tile_capacity(positions.shape[0], mesh_dims)
            tiles = sw.build_mesh_tiles(
                positions, cell, mesh_dims, spline_order, cap, need_grad=False
            )

            def fast(_):
                if channels:
                    return jnp.stack(
                        [sw.windowed_spread(tiles, values[:, ci])
                         for ci in range(values.shape[1])],
                        axis=0,
                    )
                return sw.windowed_spread(tiles, values)

            return jax.lax.cond(tiles.counts_max <= cap, fast, dense, None)
        return dense(None)

    gidx, w, _, _ = _stencil(positions, cell, mesh_dims, spline_order, batch_idx)
    flat = _flat_indices(gidx, mesh_dims, batch_idx, num_systems)
    wxyz = jnp.einsum("ni,nj,nk->nijk", w[:, 0], w[:, 1], w[:, 2]).reshape(
        positions.shape[0], spline_order**3
    )
    total = num_systems * nx * ny * nz
    if channels:
        c = values.shape[1]
        planes = [
            jnp.zeros((total,), dtype=dtype)
            .at[flat.reshape(-1)]
            .add((values[:, ci:ci + 1] * wxyz).reshape(-1))
            for ci in range(c)
        ]
        mesh = jnp.stack(planes, axis=0).reshape(c, num_systems, nx, ny, nz)
        mesh = jnp.moveaxis(mesh, 0, 1)  # [B, C, nx, ny, nz]
        return mesh[0] if num_systems == 1 and batch_idx is None else mesh
    contrib = values[:, None] * wxyz
    mesh = jnp.zeros((total,), dtype=dtype).at[flat.reshape(-1)].add(contrib.reshape(-1))
    mesh = mesh.reshape(num_systems, nx, ny, nz)
    return mesh[0] if num_systems == 1 and batch_idx is None else mesh


def spline_spread(positions, values, cell, mesh_dims, spline_order: int = 4,
                  batch_idx=None, cell_inv_t=None):
    """Spread per-atom values onto a periodic mesh (reference: spline.py:2581-2638).

    Returns (nx, ny, nz) for single system, (B, nx, ny, nz) when batched.
    """
    del cell_inv_t  # the inverse is cheap; kept for API compatibility
    ns = _num_systems(cell, batch_idx)
    return _spread_impl(
        positions, values, cell, batch_idx, tuple(mesh_dims), spline_order, ns, False
    )


def spline_spread_channels(positions, values, cell, mesh_dims, spline_order: int = 4,
                           batch_idx=None):
    """Multi-channel spread -> (C, nx, ny, nz) or (B, C, nx, ny, nz).

    (reference: spline.py:2788-2861.)
    """
    ns = _num_systems(cell, batch_idx)
    return _spread_impl(
        positions, values, cell, batch_idx, tuple(mesh_dims), spline_order, ns, True
    )


@partial(jax.jit, static_argnames=("spline_order", "num_systems", "mode"))
def _gather_impl(positions, mesh, charges, cell, batch_idx, spline_order, num_systems, mode):
    dtype = positions.dtype
    n = positions.shape[0]
    o = spline_order

    if batch_idx is None and num_systems == 1:
        from nvalchemiops_tpu import spline_windowed as sw

        if mode == "vec3":
            dims = mesh.shape[0:3]
        elif mode == "channels":
            dims = mesh.shape[1:4] if mesh.ndim == 4 else mesh.shape[0:3]
        else:
            dims = mesh.shape[-3:]

        def dense(_):
            if mode == "scalar":
                (sx, sy, sz), _u = _stencil_axis_matrices(positions, cell, dims, o, None)
                return _separable_gather(mesh, sx, sy, sz)
            if mode == "vec3":
                (sx, sy, sz), _u = _stencil_axis_matrices(positions, cell, dims, o, None)
                comps = [
                    charges * _separable_gather(mesh[..., ci], sx, sy, sz)
                    for ci in range(3)
                ]
                return jnp.stack(comps, axis=-1)
            if mode == "channels":
                c = mesh.shape[0]
                (sx, sy, sz), _u = _stencil_axis_matrices(positions, cell, dims, o, None)
                return jnp.stack(
                    [_separable_gather(mesh[ci], sx, sy, sz) for ci in range(c)], axis=-1
                )
            f_comps = []
            for d in range(3):
                (sx, sy, sz), inv = _stencil_axis_matrices(
                    positions, cell, dims, o, None, derivative_axis=d
                )
                f_comps.append(-charges * _separable_gather(mesh, sx, sy, sz))
            f_frac = jnp.stack(f_comps, axis=-1)
            return apply_mat3(f_frac, inv[0].T)

        if sw.windowed_applicable(dims, o):
            cap = sw.mesh_tile_capacity(positions.shape[0], dims)
            tiles = sw.build_mesh_tiles(
                positions, cell, dims, o, cap, need_grad=(mode == "gradient")
            )

            def fast(_):
                if mode == "scalar":
                    return sw.windowed_gather(tiles, mesh)
                if mode == "vec3":
                    return jnp.stack(
                        [charges * sw.windowed_gather(tiles, mesh[..., ci])
                         for ci in range(3)],
                        axis=-1,
                    )
                if mode == "channels":
                    return jnp.stack(
                        [sw.windowed_gather(tiles, mesh[ci])
                         for ci in range(mesh.shape[0])],
                        axis=-1,
                    )
                _vals, g = sw.windowed_gather(tiles, mesh, with_gradient=True)
                return apply_mat3(-charges[:, None] * g, tiles.inv.T)

            return jax.lax.cond(tiles.counts_max <= cap, fast, dense, None)
        return dense(None)

    # per-plane flattening: vector/channel meshes are gathered one scalar
    # plane at a time (no gathers of arrays with a small trailing dim).
    if mode == "channels":
        mesh_b = mesh if mesh.ndim == 5 else mesh[None]  # [B, C, nx, ny, nz]
        c = mesh_b.shape[1]
        dims = mesh_b.shape[2:5]
        mesh_planes = [mesh_b[:, ci].reshape(-1) for ci in range(c)]
    elif mode == "vec3":
        mesh_b = mesh if mesh.ndim == 5 else mesh[None]  # [B, nx, ny, nz, 3]
        dims = mesh_b.shape[1:4]
        mesh_planes = [mesh_b[..., ci].reshape(-1) for ci in range(3)]
    else:
        mesh_b = mesh if mesh.ndim == 4 else mesh[None]  # [B, nx, ny, nz]
        dims = mesh_b.shape[1:4]
        mesh_flat = mesh_b.reshape(-1)

    gidx, w, dw, inv = _stencil(positions, cell, dims, o, batch_idx)
    flat = _flat_indices(gidx, dims, batch_idx, num_systems)
    wxyz = jnp.einsum("ni,nj,nk->nijk", w[:, 0], w[:, 1], w[:, 2]).reshape(n, o**3)

    if mode == "scalar":
        vals = mesh_flat[flat]  # [N, o^3]
        return jnp.sum(vals * wxyz, axis=1)
    if mode == "vec3":
        comps = [
            charges * jnp.sum(plane[flat] * wxyz, axis=1) for plane in mesh_planes
        ]
        return jnp.stack(comps, axis=-1)
    if mode == "channels":
        comps = [jnp.sum(plane[flat] * wxyz, axis=1) for plane in mesh_planes]
        return jnp.stack(comps, axis=-1)
    if mode == "gradient":
        vals = mesh_flat[flat]  # [N, o^3]
        # separable gradient: (dwx wy wz, wx dwy wz, wx wy dwz)
        gx = jnp.einsum("ni,nj,nk->nijk", dw[:, 0], w[:, 1], w[:, 2]).reshape(n, o**3)
        gy = jnp.einsum("ni,nj,nk->nijk", w[:, 0], dw[:, 1], w[:, 2]).reshape(n, o**3)
        gz = jnp.einsum("ni,nj,nk->nijk", w[:, 0], w[:, 1], dw[:, 2]).reshape(n, o**3)
        f_frac = -charges[:, None] * jnp.stack(
            [jnp.sum(vals * gx, axis=1), jnp.sum(vals * gy, axis=1), jnp.sum(vals * gz, axis=1)],
            axis=-1,
        )  # [N, 3] in fractional axes
        if batch_idx is not None and inv.shape[0] > 1:
            inv_a = inv[batch_idx.astype(INDEX_DTYPE)]
            return sum(f_frac[:, d:d + 1] * inv_a[:, :, d] for d in range(3))
        return apply_mat3(f_frac, inv[0].T)
    raise ValueError(mode)


def spline_gather(positions, mesh, cell, spline_order: int = 4, batch_idx=None,
                  cell_inv_t=None):
    """Interpolate mesh values at atom positions (reference: spline.py:2640-2682)."""
    del cell_inv_t
    ns = _num_systems(cell, batch_idx)
    return _gather_impl(positions, mesh, None, cell, batch_idx, spline_order, ns, "scalar")


def spline_gather_vec3(positions, charges, mesh, cell, spline_order: int = 4,
                       batch_idx=None, cell_inv_t=None):
    """Charge-weighted vector-field interpolation (reference: spline.py:2684-2731)."""
    del cell_inv_t
    ns = _num_systems(cell, batch_idx)
    return _gather_impl(positions, mesh, charges, cell, batch_idx, spline_order, ns, "vec3")


def spline_gather_gradient(positions, charges, mesh, cell, spline_order: int = 4,
                           batch_idx=None, cell_inv_t=None):
    """Forces ``F_i = -q_i sum_g phi(g) grad w`` (reference: spline.py:2733-2786)."""
    del cell_inv_t
    ns = _num_systems(cell, batch_idx)
    return _gather_impl(positions, mesh, charges, cell, batch_idx, spline_order, ns, "gradient")


def spline_gather_channels(positions, mesh, cell, spline_order: int = 4, batch_idx=None):
    """Multi-channel interpolation (reference: spline.py:2863-2915)."""
    ns = _num_systems(cell, batch_idx)
    return _gather_impl(positions, mesh, None, cell, batch_idx, spline_order, ns, "channels")


# ---------------------------------------------------------------------------
# Deconvolution (reference: spline.py:2917-3190)
# ---------------------------------------------------------------------------

_BSPLINE_INTEGER_VALUES = {
    1: [1.0],
    2: [0.5, 0.5],
    3: [1 / 6, 4 / 6, 1 / 6],
    4: [1 / 24, 11 / 24, 11 / 24, 1 / 24],
    5: [1 / 120, 26 / 120, 66 / 120, 26 / 120, 1 / 120],
}


def _bspline_modulus_sq(k, n: int, order: int):
    """|b(k)|^2 of the cardinal B-spline (Essmann et al. 1995, Eq. 4.7)."""
    k = jnp.asarray(k, dtype=jnp.result_type(float))
    m_vals = _BSPLINE_INTEGER_VALUES[order]
    w = 2.0 * math.pi * k / n
    b_re = sum(m_vals[j] * jnp.cos(w * j) for j in range(order))
    b_im = sum(m_vals[j] * jnp.sin(w * j) for j in range(order))
    b_sq = b_re**2 + b_im**2
    return jnp.where(k == 0, jnp.ones_like(b_sq), b_sq)


def compute_bspline_deconvolution_1d(n: int, spline_order: int = 4):
    """1-D deconvolution factors 1/|b(k)|^2 on the full FFT grid."""
    k = jnp.fft.fftfreq(n) * n
    return 1.0 / jnp.clip(_bspline_modulus_sq(k, n, spline_order), 1e-15)


def compute_bspline_deconvolution(mesh_dims, spline_order: int = 4):
    """Separable 3-D deconvolution ``1/(|bx|^2 |by|^2 |bz|^2)`` on the fftn grid.

    Multiply with ``fftn(mesh)`` to undo B-spline smoothing
    (reference: spline.py:3038-3115).
    """
    nx, ny, nz = mesh_dims
    bx = _bspline_modulus_sq(jnp.fft.fftfreq(nx) * nx, nx, spline_order)
    by = _bspline_modulus_sq(jnp.fft.fftfreq(ny) * ny, ny, spline_order)
    bz = _bspline_modulus_sq(jnp.fft.fftfreq(nz) * nz, nz, spline_order)
    b3 = bx[:, None, None] * by[None, :, None] * bz[None, None, :]
    return 1.0 / jnp.clip(b3, 1e-15)
