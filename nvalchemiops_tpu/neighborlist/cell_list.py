# SPDX-License-Identifier: Apache-2.0
"""O(N) cell-list neighbor construction, single system.

JAX counterpart of ``nvalchemiops/neighborlist/cell_list.py``.  The
reference builds its cell list with atomic bin counters and fills the
neighbor matrix with a per-thread half-space cell sweep + atomic symmetric
insertion (cell_list.py:166-556).  This rebuild keeps the exact same public
artifacts and output contract but re-architects both phases without
atomics:

Build (sort-based, deterministic, scatter-free):
    fractional coords -> cell coords (+ periodic wrap bookkeeping) ->
    linear cell ids -> one ``argsort`` -> CSR layout via vectorized
    ``searchsorted``.  This reproduces ``cell_atom_list`` /
    ``cell_atom_start_indices`` / ``atoms_per_cell_count`` with atoms sorted
    ascending within each cell.

Query (gather + top-k, row-owner):
    each atom gathers the fixed-capacity occupant lists of the
    ``(2R+1)^3`` surrounding cells (full-space sweep: every row owns all its
    pairs, so no atomics and no dedup are needed — distinct cell offsets
    always yield distinct ``(j, shift)`` images), computes all candidate
    distances as dense vectorized arithmetic, and packs hits with the
    deterministic top-k compaction from ``neighbor_utils``.

Shift algebra matches cell_list.py:372-556: for a pair (i, j) found through
cell offset ``d``, ``S = wrap(c_i + d) + aps_i - aps_j`` on periodic axes
(0 elsewhere), and ``r_pair = r_j + S @ cell - r_i``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    decode_keys,
    get_neighbor_list_from_neighbor_matrix,
    estimate_max_neighbors,
    merge_topk,
    pack_block,
    pack_shifts,
    shifts_to_aos,
)

__all__ = [
    "CellList",
    "estimate_cell_list_sizes",
    "build_cell_list",
    "query_cell_list",
    "cell_list",
]


class CellList(NamedTuple):
    """Cell-list artifacts (same fields the reference returns/mutates)."""

    cells_per_dimension: jax.Array  # [3] int32
    neighbor_search_radius: jax.Array  # [3] int32
    atom_periodic_shifts: jax.Array  # [N, 3] int32
    atom_to_cell_mapping: jax.Array  # [N, 3] int32
    atoms_per_cell_count: jax.Array  # [max_total_cells] int32
    cell_atom_start_indices: jax.Array  # [max_total_cells] int32
    cell_atom_list: jax.Array  # [N] int32


# ---------------------------------------------------------------------------
# Host-side sizing (reference: cell_list.py:35-99, 639-724)
# ---------------------------------------------------------------------------


def _cells_per_dimension_host(cell: np.ndarray, cutoff: float, max_nbins: int):
    """Cell counts per dimension and face distances (reference formula)."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell).T
    face_distance = 1.0 / np.linalg.norm(inv_t, axis=1)
    cpd = np.maximum((face_distance / float(cutoff)).astype(np.int64), 1)
    while int(np.prod(cpd)) > max_nbins:
        cpd = np.maximum(cpd // 2, 1)
    return cpd, face_distance


def estimate_cell_list_sizes(cell, pbc, cutoff: float, max_nbins: int = 1000):
    """Host-side allocation estimate (requires concrete ``cell``).

    Returns ``(max_total_cells, neighbor_search_radius)`` exactly like the
    reference (cell_list.py:639-724): the cell grid dimensions after the
    halve-until-under-``max_nbins`` loop, and the per-dimension search radius
    ``ceil(cutoff / bin_width)`` (0 for single-cell non-periodic dimensions).
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(-1, 3, 3)[0]
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1)[:3]
    if cutoff <= 0:
        return 1, jnp.zeros((3,), dtype=INDEX_DTYPE)
    cpd, face_distance = _cells_per_dimension_host(cell_np, cutoff, max_nbins)
    radius = np.ceil(float(cutoff) * cpd / face_distance).astype(np.int64)
    radius = np.where((cpd == 1) & ~pbc_np, 0, radius)
    return int(np.prod(cpd)), jnp.asarray(radius, dtype=INDEX_DTYPE)


def _estimate_cell_capacity(
    total_atoms: int, max_total_cells: int, safety_factor: float = 2.0
) -> int:
    """Static per-cell capacity estimate, rounded up to a multiple of 8."""
    if total_atoms == 0:
        return 8
    mean = total_atoms / max(max_total_cells, 1)
    cap = int(np.ceil(safety_factor * max(mean, 1.0) / 8)) * 8
    return max(cap, 8)


# ---------------------------------------------------------------------------
# Build (jit, sort-based)
# ---------------------------------------------------------------------------


def _bin_atoms(positions, cell, pbc_arr, cpd):
    """Cell coords + periodic shifts for each atom (reference: :166-240)."""
    inv_cell = jnp.linalg.inv(cell)
    from nvalchemiops_tpu.mathops.math import apply_mat3
    frac = apply_mat3(positions, inv_cell)  # s = r @ cell^-1, exact f32
    coords = jnp.floor(frac * cpd.astype(positions.dtype)).astype(INDEX_DTYPE)
    wrap = jnp.floor_divide(coords, cpd)
    wrapped = coords - wrap * cpd
    clamped = jnp.clip(coords, 0, cpd - 1)
    aps = jnp.where(pbc_arr[None, :], wrap, 0).astype(INDEX_DTYPE)
    cell_coords = jnp.where(pbc_arr[None, :], wrapped, clamped).astype(INDEX_DTYPE)
    return cell_coords, aps


def allocate_cell_list(total_atoms: int, max_total_cells: int,
                       neighbor_search_radius=None) -> CellList:
    """Zero-filled :class:`CellList` with the given static capacities.

    Counterpart of the reference's buffer pre-allocation
    (neighbor_utils.py:494-539).  In the functional JAX model the build
    returns fresh arrays, so this exists for (a) API parity, (b) seeding
    ``jax.jit`` donation / ``lax.cond`` branches that need a CellList of
    the right shapes before the first real build.
    """
    radius = (jnp.zeros((3,), INDEX_DTYPE) if neighbor_search_radius is None
              else jnp.asarray(neighbor_search_radius, INDEX_DTYPE))
    return CellList(
        cells_per_dimension=jnp.zeros((3,), INDEX_DTYPE),
        neighbor_search_radius=radius,
        atom_periodic_shifts=jnp.zeros((total_atoms, 3), INDEX_DTYPE),
        atom_to_cell_mapping=jnp.zeros((total_atoms, 3), INDEX_DTYPE),
        atoms_per_cell_count=jnp.zeros((max_total_cells,), INDEX_DTYPE),
        cell_atom_start_indices=jnp.zeros((max_total_cells,), INDEX_DTYPE),
        cell_atom_list=jnp.zeros((total_atoms,), INDEX_DTYPE),
    )


@partial(jax.jit, static_argnames=("max_total_cells", "max_nbins"))
def build_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    max_total_cells: int,
    max_nbins: int = 1000,
) -> CellList:
    """Build the spatial cell list (jit-compatible, static capacities).

    Functional equivalent of the reference's ``build_cell_list``
    (cell_list.py:1037-1106): instead of mutating pre-allocated buffers it
    returns a :class:`CellList`.  ``max_total_cells`` must come from
    :func:`estimate_cell_list_sizes` (host side), exactly like the reference
    splits non-compilable estimation from the compilable build.
    """
    n = positions.shape[0]
    dtype = positions.dtype
    cell = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    pbc_arr = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]

    # cells per dimension (dynamic values, same formula as the host estimate)
    inv_t = jnp.linalg.inv(cell).T
    face_distance = 1.0 / jnp.linalg.norm(inv_t, axis=1)
    cutoff_t = jnp.asarray(cutoff, dtype=dtype)
    cpd0 = jnp.maximum((face_distance / cutoff_t).astype(INDEX_DTYPE), 1)

    def halve(_, cpd):
        too_many = cpd[0] * cpd[1] * cpd[2] > max_nbins
        return jnp.where(too_many, jnp.maximum(cpd // 2, 1), cpd)

    cpd = jax.lax.fori_loop(0, 32, halve, cpd0)

    radius = jnp.ceil(
        cutoff_t * cpd.astype(dtype) / face_distance
    ).astype(INDEX_DTYPE)
    radius = jnp.where((cpd == 1) & ~pbc_arr, 0, radius)

    cell_coords, aps = _bin_atoms(positions, cell, pbc_arr, cpd)
    linear = cell_coords[:, 0] + cpd[0] * (cell_coords[:, 1] + cpd[1] * cell_coords[:, 2])

    order = jnp.argsort(linear, stable=True).astype(INDEX_DTYPE)
    sorted_ids = linear[order]

    cell_range = jnp.arange(max_total_cells, dtype=INDEX_DTYPE)
    starts = jnp.searchsorted(sorted_ids, cell_range, side="left").astype(INDEX_DTYPE)
    ends = jnp.searchsorted(sorted_ids, cell_range, side="right").astype(INDEX_DTYPE)
    counts = ends - starts

    return CellList(
        cells_per_dimension=cpd.astype(INDEX_DTYPE),
        neighbor_search_radius=radius,
        atom_periodic_shifts=aps,
        atom_to_cell_mapping=cell_coords,
        atoms_per_cell_count=counts,
        cell_atom_start_indices=starts,
        cell_atom_list=order,
    )


# ---------------------------------------------------------------------------
# Query (jit, gather + top-k)
# ---------------------------------------------------------------------------


def _offset_table(search_radius: tuple[int, int, int], half_fill: bool) -> np.ndarray:
    """Static cell-offset sweep table.

    Full space for ``half_fill=False`` (row-owner enumeration), half space
    (reference condition at cell_list.py:471-475) for ``half_fill=True``.
    Home cell (0,0,0) first for determinism of the home-cell j>i rule.
    """
    rx, ry, rz = (int(r) for r in search_radius)
    offs = []
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                if half_fill and not (
                    dx > 0 or (dx == 0 and dy > 0) or (dx == 0 and dy == 0 and dz >= 0)
                ):
                    continue
                offs.append((dx, dy, dz))
    offs = np.asarray(offs, dtype=np.int32).reshape(-1, 3)
    order = np.lexsort((offs[:, 2], offs[:, 1], offs[:, 0], (offs != 0).any(axis=1)))
    return offs[order]


@partial(
    jax.jit,
    static_argnames=(
        "search_radius",
        "cell_capacity",
        "max_neighbors",
        "half_fill",
        "fill_value",
        "row_block",
    ),
)
def query_cell_list_packed(
    positions,
    cutoff,
    cell,
    pbc,
    cell_list_data: CellList,
    search_radius: tuple[int, int, int],
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
):
    """Query the cell list into a padded neighbor matrix (packed shifts).

    Functional counterpart of reference ``query_cell_list``
    (cell_list.py:1108-1193).  ``search_radius`` / ``cell_capacity`` /
    ``max_neighbors`` are static (host-estimated) capacities.

    Everything inside is structure-of-arrays 2-D: positions/shifts are
    handled as separate x/y/z planes and the output shifts come back as one
    bit-packed int32 per pair (see neighbor_utils.pack_shifts).

    Returns ``(neighbor_matrix [N,K], num_neighbors [N],
    packed_shifts [N,K])``.
    """
    n = positions.shape[0]
    dtype = positions.dtype
    cell = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    pbc_arr = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]
    cutoff_sq = jnp.asarray(cutoff, dtype=dtype) ** 2

    cl = cell_list_data
    cpd = cl.cells_per_dimension
    k = max_neighbors

    if n == 0:
        return (
            jnp.full((0, k), fill_value, dtype=INDEX_DTYPE),
            jnp.zeros((0,), dtype=INDEX_DTYPE),
            jnp.full((0, k), pack_shifts(*(jnp.zeros((), INDEX_DTYPE),) * 3), dtype=INDEX_DTYPE),
        )

    offsets = jnp.asarray(_offset_table(search_radius, half_fill))  # [O, 3]
    num_offsets = offsets.shape[0]
    cap = cell_capacity
    num_cand = num_offsets * cap

    # fixed-capacity per-cell occupant view (gather from CSR layout)
    slot = jnp.arange(cap, dtype=INDEX_DTYPE)
    flat_idx = cl.cell_atom_start_indices[:, None] + slot[None, :]
    in_cell = slot[None, :] < cl.atoms_per_cell_count[:, None]
    padded_cells = jnp.where(
        in_cell,
        cl.cell_atom_list[jnp.clip(flat_idx, 0, max(n - 1, 0))],
        jnp.asarray(n, dtype=INDEX_DTYPE),
    )  # [M, cap]; n == invalid

    home_offset = jnp.all(offsets == 0, axis=1)  # [O]
    pbc_i = pbc_arr.astype(INDEX_DTYPE)

    num_blocks = -(-n // row_block)
    n_pad = num_blocks * row_block
    pad_n = n_pad - n

    # per-component padded planes (SoA)
    px = jnp.pad(positions[:, 0], (0, pad_n))
    py = jnp.pad(positions[:, 1], (0, pad_n))
    pz = jnp.pad(positions[:, 2], (0, pad_n))
    coords_pad = jnp.pad(cl.atom_to_cell_mapping, ((0, pad_n), (0, 0)))
    apx = jnp.pad(cl.atom_periodic_shifts[:, 0], (0, pad_n))
    apy = jnp.pad(cl.atom_periodic_shifts[:, 1], (0, pad_n))
    apz = jnp.pad(cl.atom_periodic_shifts[:, 2], (0, pad_n))
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
        rv = jax.lax.dynamic_slice(row_valid_pad, (start,), (row_block,))

        target = c_i[:, None, :] + offsets[None, :, :]  # [B, O, 3]
        wrap = jnp.floor_divide(target, cpd[None, None, :])
        wrapped = target - wrap * cpd[None, None, :]
        # non-periodic dims: offsets leaving the grid are invalid
        in_range = (target >= 0) & (target < cpd[None, None, :])
        off_valid = jnp.all(pbc_arr[None, None, :] | in_range, axis=-1)  # [B, O]
        m = jnp.where(pbc_arr[None, None, :], wrapped, jnp.clip(target, 0, cpd - 1))
        lin = m[..., 0] + cpd[0] * (m[..., 1] + cpd[1] * m[..., 2])  # [B, O]
        lin = jnp.clip(lin, 0, padded_cells.shape[0] - 1)

        cand = padded_cells[lin]  # [B, O, cap] (row gather: well tiled)
        cand_flat = cand.reshape(row_block, num_cand)
        cand_c = jnp.minimum(cand_flat, n - 1)

        def expand(o_arr):  # [B, O] -> [B, num_cand]
            return jnp.repeat(o_arr, cap, axis=1)

        # pair shift components: S = wrap + aps_i - aps_j on periodic axes
        sx = (expand(wrap[..., 0]) + aix[:, None] - apx[cand_c]) * pbc_i[0]
        sy = (expand(wrap[..., 1]) + aiy[:, None] - apy[cand_c]) * pbc_i[1]
        sz = (expand(wrap[..., 2]) + aiz[:, None] - apz[cand_c]) * pbc_i[2]

        sxf = sx.astype(dtype)
        syf = sy.astype(dtype)
        szf = sz.astype(dtype)
        # cartesian shift = S @ cell (cell rows are lattice vectors)
        shx = sxf * cell[0, 0] + syf * cell[1, 0] + szf * cell[2, 0]
        shy = sxf * cell[0, 1] + syf * cell[1, 1] + szf * cell[2, 1]
        shz = sxf * cell[0, 2] + syf * cell[1, 2] + szf * cell[2, 2]

        dx = px[cand_c] + shx - rix[:, None]
        dy = py[cand_c] + shy - riy[:, None]
        dz = pz[cand_c] + shz - riz[:, None]
        d2 = dx * dx + dy * dy + dz * dz

        valid_cand = cand_flat < n
        off_valid_flat = expand(off_valid)
        home_flat = expand(jnp.broadcast_to(home_offset[None, :], (row_block, num_offsets)))
        if half_fill:
            home_excl = home_flat & (cand_flat <= rows[:, None])
        else:
            home_excl = home_flat & (cand_flat == rows[:, None])
        mask = (
            (d2 < cutoff_sq)
            & valid_cand
            & off_valid_flat
            & ~home_excl
            & rv[:, None]
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
        zero_code = pack_shifts(
            jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE)
        )
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


def query_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    cell_list_data: CellList,
    search_radius: tuple[int, int, int],
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
    shift_format: str = "aos",
):
    """Query returning shifts in the requested layout.

    ``shift_format="aos"`` gives the reference-parity [N, K, 3] matrix;
    ``"packed"`` keeps the one-int32-per-pair encoding (use this at
    scale — a third of the AoS layout's memory).
    """
    nm, num, sh = query_cell_list_packed(
        positions, cutoff, cell, pbc, cell_list_data, search_radius,
        cell_capacity, max_neighbors, half_fill=half_fill,
        fill_value=fill_value, row_block=row_block,
    )
    if shift_format == "packed":
        return nm, num, sh
    return nm, num, shifts_to_aos(sh)


# ---------------------------------------------------------------------------
# Public one-shot API (reference: cell_list.py:1195-1443)
# ---------------------------------------------------------------------------


def cell_list(
    positions,
    cutoff: float,
    cell,
    pbc,
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
    """Build + query in one call, with automatic capacity estimation.

    Mirrors the reference convenience wrapper (cell_list.py:1195-1443);
    capacity overflows are detected and retried with enlarged static sizes
    (the reference instead relies on caller-provided sizes + overflow
    detection downstream).
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    if max_neighbors is None:
        if neighbor_matrix is not None:
            max_neighbors = int(neighbor_matrix.shape[1])
        else:
            max_neighbors = estimate_max_neighbors(cutoff)

    max_total_cells, radius = estimate_cell_list_sizes(cell, pbc, cutoff, max_nbins)
    radius_t = tuple(int(v) for v in jax.device_get(radius))

    cl = build_cell_list(positions, cutoff, cell, pbc, max_total_cells, max_nbins)

    if cell_capacity is None:
        cap = _estimate_cell_capacity(total_atoms, max_total_cells)
        observed = int(jax.device_get(jnp.max(cl.atoms_per_cell_count)))
        if observed > cap:
            cap = int(np.ceil(observed / 8)) * 8
    else:
        cap = int(cell_capacity)

    nm, num, sh = query_cell_list(
        positions,
        cutoff,
        cell,
        pbc,
        cl,
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
