# SPDX-License-Identifier: Apache-2.0
"""Batched O(N) cell-list neighbor construction.

JAX counterpart of ``nvalchemiops/neighborlist/batch_cell_list.py``
(kernels at batch_cell_list.py:35-657, wrappers at :659-1468).  Per-system
cell grids are packed into one flat array with a uniform per-system stride
(the reference packs with exact per-system offsets; a uniform stride keeps
every shape static and the system lookup branch-free).  Build and query use
the same sort + gather + top-k architecture as the single-system module,
with every per-system quantity (cell grid dims, pbc flags, cell matrix)
gathered per atom through ``batch_idx``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist.cell_list import (
    _cells_per_dimension_host,
    _estimate_cell_capacity,
    _offset_table,
)
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    decode_keys,
    pack_shifts,
    shifts_to_aos,
    estimate_max_neighbors,
    get_neighbor_list_from_neighbor_matrix,
    merge_topk,
    pack_block,
    prepare_batch_idx_ptr,
)

__all__ = [
    "BatchCellList",
    "estimate_batch_cell_list_sizes",
    "batch_build_cell_list",
    "batch_query_cell_list",
    "batch_cell_list",
]


class BatchCellList(NamedTuple):
    """Batched cell-list artifacts (per-system grids in one flat layout)."""

    cells_per_dimension: jax.Array  # [B, 3] int32
    neighbor_search_radius: jax.Array  # [B, 3] int32
    atom_periodic_shifts: jax.Array  # [N, 3] int32
    atom_to_cell_mapping: jax.Array  # [N, 3] int32
    atoms_per_cell_count: jax.Array  # [B * stride] int32
    cell_atom_start_indices: jax.Array  # [B * stride] int32
    cell_atom_list: jax.Array  # [N] int32


def estimate_batch_cell_list_sizes(cell, pbc, cutoff: float, max_nbins: int = 1000):
    """Host-side sizing for the batched cell list.

    Returns ``(cell_stride, max_total_cells, neighbor_search_radius [B,3])``:
    ``cell_stride`` is the per-system flat-grid stride (max cells over the
    batch) and ``max_total_cells = num_systems * cell_stride``.
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(-1, 3, 3)
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1, 3)
    if pbc_np.shape[0] == 1 and cell_np.shape[0] > 1:
        pbc_np = np.broadcast_to(pbc_np, (cell_np.shape[0], 3))
    num_systems = cell_np.shape[0]
    radius = np.zeros((num_systems, 3), dtype=np.int64)
    totals = np.zeros(num_systems, dtype=np.int64)
    for b in range(num_systems):
        cpd, face = _cells_per_dimension_host(cell_np[b], cutoff, max_nbins)
        r = np.ceil(float(cutoff) * cpd / face).astype(np.int64)
        r = np.where((cpd == 1) & ~pbc_np[b], 0, r)
        radius[b] = r
        totals[b] = int(np.prod(cpd))
    stride = int(totals.max()) if num_systems else 1
    return stride, num_systems * stride, jnp.asarray(radius, dtype=INDEX_DTYPE)


@partial(jax.jit, static_argnames=("cell_stride", "max_nbins"))
def batch_build_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    batch_idx,
    cell_stride: int,
    max_nbins: int = 1000,
) -> BatchCellList:
    """Build per-system cell lists packed into one flat layout (jit)."""
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    num_systems = cell_b.shape[0]
    pbc_b = jnp.broadcast_to(
        jnp.asarray(pbc, dtype=bool).reshape(-1, 3), (num_systems, 3)
    )
    batch_idx = batch_idx.astype(INDEX_DTYPE)

    inv = jnp.linalg.inv(cell_b)  # [B, 3, 3]
    inv_t = jnp.swapaxes(inv, -1, -2)
    face = 1.0 / jnp.linalg.norm(inv_t, axis=-1)  # [B, 3]
    cutoff_t = jnp.asarray(cutoff, dtype=dtype)
    cpd0 = jnp.maximum((face / cutoff_t).astype(INDEX_DTYPE), 1)

    def halve(_, cpd):
        too_many = (cpd[:, 0] * cpd[:, 1] * cpd[:, 2] > max_nbins)[:, None]
        return jnp.where(too_many, jnp.maximum(cpd // 2, 1), cpd)

    cpd = jax.lax.fori_loop(0, 32, halve, cpd0)
    radius = jnp.ceil(cutoff_t * cpd.astype(dtype) / face).astype(INDEX_DTYPE)
    radius = jnp.where((cpd == 1) & ~pbc_b, 0, radius)

    # per-atom binning with the atom's own system quantities
    inv_a = inv[batch_idx]  # [N, 3, 3]
    frac = jnp.einsum("nd,nde->ne", positions, inv_a)
    cpd_a = cpd[batch_idx]
    pbc_a = pbc_b[batch_idx]
    coords = jnp.floor(frac * cpd_a.astype(dtype)).astype(INDEX_DTYPE)
    wrap = jnp.floor_divide(coords, cpd_a)
    wrapped = coords - wrap * cpd_a
    clamped = jnp.clip(coords, 0, cpd_a - 1)
    aps = jnp.where(pbc_a, wrap, 0).astype(INDEX_DTYPE)
    cell_coords = jnp.where(pbc_a, wrapped, clamped).astype(INDEX_DTYPE)

    lin_local = cell_coords[:, 0] + cpd_a[:, 0] * (
        cell_coords[:, 1] + cpd_a[:, 1] * cell_coords[:, 2]
    )
    lin = batch_idx * cell_stride + lin_local

    order = jnp.argsort(lin, stable=True).astype(INDEX_DTYPE)
    sorted_ids = lin[order]
    total_cells = num_systems * cell_stride
    cell_range = jnp.arange(total_cells, dtype=INDEX_DTYPE)
    starts = jnp.searchsorted(sorted_ids, cell_range, side="left").astype(INDEX_DTYPE)
    ends = jnp.searchsorted(sorted_ids, cell_range, side="right").astype(INDEX_DTYPE)

    return BatchCellList(
        cells_per_dimension=cpd,
        neighbor_search_radius=radius,
        atom_periodic_shifts=aps,
        atom_to_cell_mapping=cell_coords,
        atoms_per_cell_count=ends - starts,
        cell_atom_start_indices=starts,
        cell_atom_list=order,
    )


def batch_query_cell_list_packed(
    positions,
    cutoff,
    cell,
    pbc,
    batch_idx,
    cell_list_data: BatchCellList,
    cell_stride: int,
    search_radius: tuple[int, int, int],
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
):
    """Query the batched cell list into a padded neighbor matrix (jit).

    Structure-of-arrays / packed-shift formulation (see the single-system
    query for the layout rationale); returns packed int32 shifts.
    """
    n = positions.shape[0]
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    num_systems = cell_b.shape[0]
    pbc_b = jnp.broadcast_to(
        jnp.asarray(pbc, dtype=bool).reshape(-1, 3), (num_systems, 3)
    )
    batch_idx = batch_idx.astype(INDEX_DTYPE)
    cutoff_sq = jnp.asarray(cutoff, dtype=dtype) ** 2
    cl = cell_list_data
    k = max_neighbors

    if n == 0:
        return (
            jnp.full((0, k), fill_value, dtype=INDEX_DTYPE),
            jnp.zeros((0,), dtype=INDEX_DTYPE),
            jnp.zeros((0, k), dtype=INDEX_DTYPE),
        )

    offsets = jnp.asarray(_offset_table(search_radius, half_fill))
    num_offsets = offsets.shape[0]
    cap = cell_capacity
    num_cand = num_offsets * cap

    slot = jnp.arange(cap, dtype=INDEX_DTYPE)
    flat_idx = cl.cell_atom_start_indices[:, None] + slot[None, :]
    in_cell = slot[None, :] < cl.atoms_per_cell_count[:, None]
    padded_cells = jnp.where(
        in_cell,
        cl.cell_atom_list[jnp.clip(flat_idx, 0, max(n - 1, 0))],
        jnp.asarray(n, dtype=INDEX_DTYPE),
    )

    home_offset = jnp.all(offsets == 0, axis=1)

    num_blocks = -(-n // row_block)
    n_pad = num_blocks * row_block
    pad_n = n_pad - n
    px = jnp.pad(positions[:, 0], (0, pad_n))
    py = jnp.pad(positions[:, 1], (0, pad_n))
    pz = jnp.pad(positions[:, 2], (0, pad_n))
    coords_pad = jnp.pad(cl.atom_to_cell_mapping, ((0, pad_n), (0, 0)))
    apx = jnp.pad(cl.atom_periodic_shifts[:, 0], (0, pad_n))
    apy = jnp.pad(cl.atom_periodic_shifts[:, 1], (0, pad_n))
    apz = jnp.pad(cl.atom_periodic_shifts[:, 2], (0, pad_n))
    sys_pad = jnp.pad(batch_idx, ((0, pad_n),))
    row_valid_pad = jnp.arange(n_pad, dtype=INDEX_DTYPE) < n

    def block_fn(start):
        zero = jnp.zeros((), INDEX_DTYPE)
        rows = start + jnp.arange(row_block, dtype=INDEX_DTYPE)
        rix = jax.lax.dynamic_slice(px, (start,), (row_block,))
        riy = jax.lax.dynamic_slice(py, (start,), (row_block,))
        riz = jax.lax.dynamic_slice(pz, (start,), (row_block,))
        c_i = jax.lax.dynamic_slice(coords_pad, (start, zero), (row_block, 3))
        aix = jax.lax.dynamic_slice(apx, (start,), (row_block,))
        aiy = jax.lax.dynamic_slice(apy, (start,), (row_block,))
        aiz = jax.lax.dynamic_slice(apz, (start,), (row_block,))
        s_i = jax.lax.dynamic_slice(sys_pad, (start,), (row_block,))
        rv = jax.lax.dynamic_slice(row_valid_pad, (start,), (row_block,))

        cpd_i = cl.cells_per_dimension[s_i]  # [Brow, 3]
        pbc_i_bool = pbc_b[s_i]  # [Brow, 3]
        pbc_i = pbc_i_bool.astype(INDEX_DTYPE)

        target = c_i[:, None, :] + offsets[None, :, :]  # [Brow, O, 3]
        wrap = jnp.floor_divide(target, cpd_i[:, None, :])
        wrapped = target - wrap * cpd_i[:, None, :]
        in_range = (target >= 0) & (target < cpd_i[:, None, :])
        off_valid = jnp.all(pbc_i_bool[:, None, :] | in_range, axis=-1)
        m = jnp.where(
            pbc_i_bool[:, None, :], wrapped, jnp.clip(target, 0, cpd_i[:, None, :] - 1)
        )
        lin = (
            s_i[:, None] * cell_stride
            + m[..., 0]
            + cpd_i[:, None, 0] * (m[..., 1] + cpd_i[:, None, 1] * m[..., 2])
        )
        lin = jnp.clip(lin, 0, padded_cells.shape[0] - 1)

        cand = padded_cells[lin]  # [Brow, O, cap]
        cand_flat = cand.reshape(row_block, num_cand)
        cand_c = jnp.minimum(cand_flat, n - 1)

        def expand(o_arr):
            return jnp.repeat(o_arr, cap, axis=1)

        sx = (expand(wrap[..., 0]) + aix[:, None] - apx[cand_c]) * pbc_i[:, 0:1]
        sy = (expand(wrap[..., 1]) + aiy[:, None] - apy[cand_c]) * pbc_i[:, 1:2]
        sz = (expand(wrap[..., 2]) + aiz[:, None] - apz[cand_c]) * pbc_i[:, 2:3]

        sxf = sx.astype(dtype)
        syf = sy.astype(dtype)
        szf = sz.astype(dtype)
        # per-row cell components (gathered per atom, broadcast over candidates)
        c00 = cell_b[s_i, 0, 0][:, None]; c01 = cell_b[s_i, 0, 1][:, None]; c02 = cell_b[s_i, 0, 2][:, None]
        c10 = cell_b[s_i, 1, 0][:, None]; c11 = cell_b[s_i, 1, 1][:, None]; c12 = cell_b[s_i, 1, 2][:, None]
        c20 = cell_b[s_i, 2, 0][:, None]; c21 = cell_b[s_i, 2, 1][:, None]; c22 = cell_b[s_i, 2, 2][:, None]
        shx = sxf * c00 + syf * c10 + szf * c20
        shy = sxf * c01 + syf * c11 + szf * c21
        shz = sxf * c02 + syf * c12 + szf * c22

        dx = px[cand_c] + shx - rix[:, None]
        dy = py[cand_c] + shy - riy[:, None]
        dz = pz[cand_c] + shz - riz[:, None]
        d2 = dx * dx + dy * dy + dz * dz

        valid_cand = cand_flat < n
        off_valid_flat = expand(off_valid)
        home_flat = expand(
            jnp.broadcast_to(home_offset[None, :], (row_block, num_offsets))
        )
        if half_fill:
            home_excl = home_flat & (cand_flat <= rows[:, None])
        else:
            home_excl = home_flat & (cand_flat == rows[:, None])
        mask = (
            (d2 < cutoff_sq) & valid_cand & off_valid_flat & ~home_excl & rv[:, None]
        )

        pri = jnp.arange(num_cand, dtype=INDEX_DTYPE)
        keys = pack_block(mask, pri[None, :], num_cand)
        topk = merge_topk(jnp.zeros((row_block, k), dtype=INDEX_DTYPE), keys, k)
        valid, p = decode_keys(topk, num_cand)
        p = jnp.minimum(p, num_cand - 1)
        j = jnp.take_along_axis(cand_flat, p, axis=1)
        packed_all = pack_shifts(sx, sy, sz)
        s = jnp.take_along_axis(packed_all, p, axis=1)
        nm = jnp.where(valid, j, jnp.asarray(fill_value, dtype=INDEX_DTYPE))
        zero_code = pack_shifts(zero, zero, zero)
        sh = jnp.where(valid, s, zero_code)
        num = jnp.sum(mask, axis=1, dtype=INDEX_DTYPE)
        return nm, num, sh

    starts = jnp.arange(num_blocks, dtype=INDEX_DTYPE) * row_block
    nm, num, sh = jax.lax.map(block_fn, starts)
    return (
        nm.reshape(n_pad, k)[:n],
        num.reshape(n_pad)[:n],
        sh.reshape(n_pad, k)[:n],
    )


batch_query_cell_list_packed = partial(
    jax.jit,
    static_argnames=(
        "cell_stride",
        "search_radius",
        "cell_capacity",
        "max_neighbors",
        "half_fill",
        "fill_value",
        "row_block",
    ),
)(batch_query_cell_list_packed)


def batch_query_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    batch_idx,
    cell_list_data: BatchCellList,
    cell_stride: int,
    search_radius: tuple[int, int, int],
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
    shift_format: str = "aos",
):
    """Query returning shifts as AoS [N,K,3] (parity) or packed int32 [N,K]."""
    nm, num, sh = batch_query_cell_list_packed(
        positions, cutoff, cell, pbc, batch_idx, cell_list_data, cell_stride,
        search_radius, cell_capacity, max_neighbors, half_fill=half_fill,
        fill_value=fill_value, row_block=row_block,
    )
    if shift_format == "packed":
        return nm, num, sh
    return nm, num, shifts_to_aos(sh)


def batch_cell_list(
    positions,
    cutoff: float,
    cell,
    pbc,
    batch_idx=None,
    batch_ptr=None,
    max_neighbors: int | None = None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    neighbor_matrix=None,
    max_nbins: int = 1000,
    cell_capacity: int | None = None,
    shift_format: str = "aos",
    **_ignored,
):
    """Build + query batched cell lists in one call.

    Mirrors the reference wrapper (batch_cell_list.py:1229-1468); same return
    patterns as the other neighbor-list entry points.
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    batch_idx, batch_ptr = prepare_batch_idx_ptr(batch_idx, batch_ptr, total_atoms)
    if max_neighbors is None:
        if neighbor_matrix is not None:
            max_neighbors = int(neighbor_matrix.shape[1])
        else:
            max_neighbors = estimate_max_neighbors(cutoff)

    stride, max_total_cells, radius = estimate_batch_cell_list_sizes(
        cell, pbc, cutoff, max_nbins
    )
    radius_np = np.asarray(jax.device_get(radius))
    radius_t = tuple(int(v) for v in radius_np.max(axis=0))

    cl = batch_build_cell_list(
        positions, cutoff, cell, pbc, batch_idx, stride, max_nbins
    )

    if cell_capacity is None:
        num_systems = int(np.asarray(jax.device_get(batch_ptr)).shape[0]) - 1
        per_sys_cells = max(stride, 1)
        cap = _estimate_cell_capacity(total_atoms, num_systems * per_sys_cells)
        observed = int(jax.device_get(jnp.max(cl.atoms_per_cell_count)))
        if observed > cap:
            cap = int(np.ceil(observed / 8)) * 8
    else:
        cap = int(cell_capacity)

    nm, num, sh = batch_query_cell_list(
        positions,
        cutoff,
        cell,
        pbc,
        batch_idx,
        cl,
        stride,
        radius_t,
        cap,
        int(max_neighbors),
        half_fill=half_fill,
        fill_value=int(fill_value),
        shift_format=shift_format,
    )

    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh, fill_value=int(fill_value)
        )
    return nm, num, sh
