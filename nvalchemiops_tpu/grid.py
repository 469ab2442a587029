# SPDX-License-Identifier: Apache-2.0
"""Halo-padded atom grid: the at-scale neighbor engine.

The reference's cell list is CSR bins + per-thread sweeps with atomic
inserts (cell_list.py:372-556).  This module enumerates neighbors with
dense, statically shaped operations instead — no per-pair gathers:

1. **Build** (one payload-carrying bucket sort + one monotone row gather):
   atoms are binned into a fixed-capacity spatial grid stored as dense
   per-property planes ``[Cz, Cy, Cx, cap]`` (positions as separate x/y/z
   planes, plus atom ids and a validity mask).
2. **Halo extension**: the grid is padded by the search radius R with
   periodic ghost cells (``jnp.pad(mode="wrap")``); ghost *positions* carry
   their periodic image shift pre-applied, and each extended cell stores its
   bit-packed unit shift.  Non-periodic directions pad with invalid cells.
3. **Pair sweep**: for every cell offset ``d`` in the (2R+1)^3 sweep, the
   candidate planes are a *static slice* of the halo grid — so pairing
   "every atom in cell c vs every atom in cell c+d" is a dense
   ``[Ncells, cap, cap]`` broadcast, streamed through a user kernel
   (Coulomb, coordination numbers, ...).

The price is slack (cap^2/occupancy^2 and cube-vs-sphere overcount, ~6-10x
more candidate pairs than a compacted list); the gain is that every
candidate costs a few flops instead of a gather.  The reference's
gather-based formulation is kept beside it (neighborlist/, the matrix
paths) as the reference.

Requires R <= cells-per-dimension on periodic axes (cutoff below the box
size); smaller boxes use the streaming/naive paths instead.
"""

from __future__ import annotations

import os

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.mathops.math import apply_mat3
from nvalchemiops_tpu.neighborlist.neighbor_utils import pack_shifts

# Parking coordinates for displacement-based validity (see build_atom_grid):
# empty slots sit at x = DISPLACE + slot * DISPLACE_SPACING.  SPACING far
# exceeds any wrapped coordinate + image shift so distinct parked slots can
# never come within a cutoff of each other or of a real atom; squares stay
# comfortably inside f32 range for grids up to ~1e7 slots.
DISPLACE = 3.0e7
DISPLACE_SPACING = 1.0e5

__all__ = [
    "AtomGrid",
    "estimate_grid_geometry",
    "build_atom_grid",
    "batch_build_atom_grid",
    "build_atom_grid_auto",
    "choose_grid_origin",
    "choose_grid_geometry",
    "grid_pair_reduce",
    "grid_row_reduce_sym",
    "row_home_mask",
    "grid_neighbor_count",
    "grid_coordination_numbers",
    "grid_coulomb_energy_forces",
    "scatter_to_grid",
    "gather_from_grid",
    "use_slot_gather",
    "row_sweep_slots",
]


@jax.tree_util.register_pytree_node_class
class AtomGrid:
    """Dense atom grid with halo (all planes [Ez, Ey, Ex, cap]).

    Registered as a pytree with static geometry metadata (dims/radius/cap
    stay Python ints under jit — they size every slice).
    """

    _fields = (
        "ext_px", "ext_py", "ext_pz", "ext_valid", "ext_aid",
        "ext_shift_code", "flat_slot", "counts_max",
    )

    def __init__(self, ext_px, ext_py, ext_pz, ext_valid, ext_aid,
                 ext_shift_code, flat_slot, counts_max, dims, radius, cap):
        self.ext_px = ext_px
        self.ext_py = ext_py
        self.ext_pz = ext_pz
        self.ext_valid = ext_valid
        self.ext_aid = ext_aid
        self.ext_shift_code = ext_shift_code
        self.flat_slot = flat_slot
        self.counts_max = counts_max
        self.dims = tuple(dims)
        self.radius = tuple(radius)
        self.cap = int(cap)

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._fields)
        return children, (self.dims, self.radius, self.cap)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dims, radius, cap = aux
        return cls(*children, dims=dims, radius=radius, cap=cap)


def estimate_grid_geometry(cell, pbc, cutoff: float, total_atoms: int,
                           target_occupancy: float = 0.66,
                           bins_per_cutoff: int = 1):
    """Host-side static geometry: grid dims, search radius, capacity.

    ``bins_per_cutoff`` > 1 trades more offsets for tighter candidate
    volumes (cube/sphere overcount 6.4x at 1, 3.7x at 2).
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell_np).T
    face = 1.0 / np.linalg.norm(inv_t, axis=1)  # distances between cell faces
    bin_target = cutoff / max(bins_per_cutoff, 1)
    # NOTE: f64 noise in the cell inverse can truncate an exact multiple
    # (243/9 -> 26.999... -> 26 bins).  Any bins >= cutoff geometry is
    # valid; choose_grid_geometry searches dims x origin x capacity.
    cpd = np.maximum((face / bin_target).astype(np.int64), 1)
    radius = np.ceil(cutoff * cpd / face).astype(np.int64)
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1)[:3]
    if (radius[pbc_np] > cpd[pbc_np]).any():
        raise ValueError(
            "grid path requires search radius <= cells per dimension "
            f"(got radius {radius}, dims {cpd}); use the naive/streaming path"
        )
    mean_occ = total_atoms / max(np.prod(cpd), 1)
    # Poisson-safe headroom: low-occupancy grids need several sigma of slack
    cap_est = max(mean_occ / target_occupancy, mean_occ + 5.0 * np.sqrt(mean_occ + 1.0))
    # round cap to a multiple of 8: cap is the second-to-last dim of every
    # pair block and a non-multiple-of-8 cap measurably degrades fusions
    cap = int(np.ceil(max(cap_est, 8.0) / 8)) * 8
    # dims ordered (Cz, Cy, Cx) for plane layout, radius likewise
    return (
        (int(cpd[2]), int(cpd[1]), int(cpd[0])),
        (int(radius[2]), int(radius[1]), int(radius[0])),
        cap,
    )


@partial(jax.jit, static_argnames=("dims", "radius", "cap"))
def build_atom_grid(positions, cell, pbc, dims, radius, cap,
                    origin=None) -> AtomGrid:
    """Bin, sort, gather into slot planes, and halo-extend (jit).

    ``origin`` (optional [3] array, xyz order, in *bin* units) shifts the
    periodic bin partition; any consistent partition is valid, and for
    near-crystalline systems a half-bin shift can cut the max occupancy
    (and with it the whole sweep cost, which scales ~cap^2) by moving
    lattice planes off bin boundaries.  See :func:`build_atom_grid_auto`.
    """
    n = positions.shape[0]
    dtype = positions.dtype
    cell = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    pbc_arr = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]
    cz, cy, cx = dims
    rz, ry, rx = radius
    cpd_xyz = jnp.asarray([cx, cy, cz], dtype=INDEX_DTYPE)  # x, y, z order

    inv_cell = jnp.linalg.inv(cell)
    frac = apply_mat3(positions, inv_cell)
    bin_pos = frac * cpd_xyz.astype(dtype)
    if origin is not None:
        bin_pos = bin_pos - jnp.asarray(origin, dtype=dtype).reshape(1, 3)
    coords = jnp.floor(bin_pos).astype(INDEX_DTYPE)  # [N,3] xyz
    wrap = jnp.floor_divide(coords, cpd_xyz)
    wrapped = coords - wrap * cpd_xyz
    clamped = jnp.clip(coords, 0, cpd_xyz - 1)
    ccoords = jnp.where(pbc_arr[None, :], wrapped, clamped)
    aps = jnp.where(pbc_arr[None, :], wrap, 0)

    # wrapped positions (images moved into the box) so ghost shifts are exact
    shift_cart = apply_mat3(aps.astype(dtype), cell)
    wpx = positions[:, 0] - shift_cart[:, 0]
    wpy = positions[:, 1] - shift_cart[:, 1]
    wpz = positions[:, 2] - shift_cart[:, 2]

    lin = ccoords[:, 0] + cx * (ccoords[:, 1] + cy * ccoords[:, 2])  # x fastest
    ncells = cx * cy * cz

    # Scatter-free slot planes: carry the wrapped positions through the
    # bucket sort as extra sort operands, locate each cell's run with a
    # vectorized binary search, and materialize the [ncells, cap] slot
    # planes with ONE row GATHER whose source indices are monotone
    # (starts[c] + r) instead of a row scatter with random destinations.
    iota = jnp.arange(n, dtype=INDEX_DTYPE)
    sorted_lin, order, spx, spy, spz = jax.lax.sort(
        (lin, iota, wpx, wpy, wpz), num_keys=1, is_stable=True)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_lin[1:] != sorted_lin[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, iota, 0))
    rank_sorted = iota - run_start
    counts_max = jnp.max(rank_sorted, initial=-1) + 1

    # atom-order slot ids (downstream per-atom scatters, rebuild detection;
    # overflow atoms land in the trash slot at the end)
    flat = jnp.zeros((n,), INDEX_DTYPE).at[order].set(
        jnp.where(rank_sorted >= cap, ncells * cap,
                  sorted_lin * cap + rank_sorted))

    # per-cell run starts via histogram + exclusive cumsum (one pass)
    counts = jnp.zeros((ncells,), INDEX_DTYPE).at[lin].add(1)
    starts = jnp.cumsum(counts) - counts
    src = starts[:, None] + jnp.arange(cap, dtype=INDEX_DTYPE)[None, :]
    valid = src < (starts + counts)[:, None]
    # flat [slots] row gather with TRULY SORTED indices: invalid slots are
    # clamped to the cell's run END (starts+counts), which is exactly the
    # next cell's first index — the flat sequence stays globally
    # non-decreasing, so indices_are_sorted=True is valid.  Clamping to a
    # CONSTANT fill row would break sortedness; leaving src UNCLAMPED
    # (starts+arange(cap)) back-jumps at every non-full cell boundary and
    # makes the sortedness hint false, which a backend may turn into
    # wrong rows for VALID slots.  Out-of-run slots read the next cell's
    # first atom (or the cap-row zero pad at the end) and are overwritten
    # by the fill select below.
    svals = jnp.concatenate(
        [jnp.stack([spx, spy, spz, order.astype(dtype)], axis=-1),
         jnp.zeros((cap, 4), dtype)], axis=0)
    srcc = jnp.minimum(src, (starts + counts)[:, None])
    planes = jnp.take(svals, srcc.reshape(-1), axis=0,
                      indices_are_sorted=True)
    planes = jnp.where(valid.reshape(-1, 1), planes,
                       jnp.asarray([[0.0, 0.0, 0.0, float(n)]], dtype))
    planes = planes.reshape(cz, cy, cx, cap, 4)
    g_px = planes[..., 0]
    g_py = planes[..., 1]
    g_pz = planes[..., 2]
    g_valid = valid.reshape(cz, cy, cx, cap)
    g_aid = planes[..., 3].astype(INDEX_DTYPE)

    # Displacement-based validity: park every empty slot at a unique far-away
    # x so the d2 < cutoff^2 test alone excludes it from every pair sweep —
    # no per-pair validity compares needed.  Unique per-slot offsets
    # (spacing >> box size)
    # keep parked slots out of range of each other; exact coincidences
    # (same-cell empties, self-images) fall to the d2 > eps guard.
    slot_iota = jnp.arange(ncells * cap, dtype=dtype).reshape(cz, cy, cx, cap)
    park = jnp.where(g_valid, 0.0, DISPLACE + slot_iota * DISPLACE_SPACING)
    g_px = g_px + park

    # halo extension
    def extend(plane, periodic_fill):
        mode = []
        out = plane
        # pad each spatial axis; wrap on periodic axes, constant elsewhere
        pads = [(rz, rz), (ry, ry), (rx, rx)]
        for ax, (p, is_pbc) in enumerate(zip(pads, (pbc_arr[2], pbc_arr[1], pbc_arr[0]))):
            cfg = [(0, 0)] * 4
            cfg[ax] = p
            wrapped_p = jnp.pad(out, cfg, mode="wrap")
            const_p = jnp.pad(out, cfg, mode="constant",
                              constant_values=periodic_fill)
            out = jnp.where(is_pbc, wrapped_p, const_p)
        return out

    ext_px = extend(g_px, DISPLACE)
    ext_py = extend(g_py, 0.0)
    ext_pz = extend(g_pz, 0.0)
    ext_valid = extend(g_valid, False)
    ext_aid = extend(g_aid, n)

    # per-extended-cell unit shift (x fastest ordering in codes)
    ez = jax.lax.broadcasted_iota(INDEX_DTYPE, (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx), 0)
    ey = jax.lax.broadcasted_iota(INDEX_DTYPE, (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx), 1)
    ex = jax.lax.broadcasted_iota(INDEX_DTYPE, (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx), 2)
    sz = jnp.floor_divide(ez - rz, jnp.asarray(cz, INDEX_DTYPE))
    sy = jnp.floor_divide(ey - ry, jnp.asarray(cy, INDEX_DTYPE))
    sx = jnp.floor_divide(ex - rx, jnp.asarray(cx, INDEX_DTYPE))
    # ghost positions: add S @ cell
    sxf, syf, szf = sx.astype(dtype), sy.astype(dtype), sz.astype(dtype)
    shx = sxf * cell[0, 0] + syf * cell[1, 0] + szf * cell[2, 0]
    shy = sxf * cell[0, 1] + syf * cell[1, 1] + szf * cell[2, 1]
    shz = sxf * cell[0, 2] + syf * cell[1, 2] + szf * cell[2, 2]
    ext_px = ext_px + shx[..., None]
    ext_py = ext_py + shy[..., None]
    ext_pz = ext_pz + shz[..., None]
    code = pack_shifts(sx, sy, sz)

    return AtomGrid(
        ext_px=ext_px,
        ext_py=ext_py,
        ext_pz=ext_pz,
        ext_valid=ext_valid,
        ext_aid=ext_aid,
        ext_shift_code=code,
        flat_slot=flat,
        dims=dims,
        radius=radius,
        cap=cap,
        counts_max=counts_max,
    )


@partial(jax.jit, static_argnames=("dims", "radius", "cap"))
def batch_build_atom_grid(positions, cells, pbc, dims, radius, cap,
                          origin=None) -> AtomGrid:
    """Fused whole-batch grid build: ``[B, npa, 3]`` → batch-axis AtomGrid.

    ``jax.vmap(build_atom_grid)`` loses all three lowerings the
    single-system build is made of — the payload-carrying sort becomes a
    batched sort, the histogram a batched scatter-add, and the monotone
    slot-row take's ``indices_are_sorted`` hint is dropped.  This builder
    keeps them flat:

    - ONE global sort over compound keys ``sys * ncells + cell`` (stable,
      so per-system ranks are identical to the single-system build),
    - ONE flat ``[B * ncells]`` histogram + exclusive cumsum,
    - ONE globally monotone row take (run-end clamping keeps the flat
      index sequence non-decreasing **across system boundaries** too),
    - then planes reshape to ``[B, Cz, Cy, Cx, cap]`` and the halo pad
      on axes 1-3 wraps each system independently for free.

    Geometry (``dims``/``radius``/``cap``) is shared across the batch
    (the library's batch contract, as with every ``batch_*`` module);
    ``cells`` may be ``[3, 3]`` (shared) or ``[B, 3, 3]``.  Returns an
    :class:`AtomGrid` whose array fields all carry a leading batch axis —
    AtomGrid is a pytree, so per-system kernels consume it via
    ``jax.vmap`` directly.  Field-for-field identical to
    ``jax.vmap(build_atom_grid)`` output (asserted in
    tests/test_grid.py).
    """
    B, npa, _ = positions.shape
    dtype = positions.dtype
    cells = jnp.asarray(cells, dtype=dtype)
    if cells.ndim == 2:
        cells = jnp.broadcast_to(cells.reshape(1, 3, 3), (B, 3, 3))
    pbc_arr = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]
    cz, cy, cx = dims
    rz, ry, rx = radius
    cpd_xyz = jnp.asarray([cx, cy, cz], dtype=INDEX_DTYPE)
    ncells = cx * cy * cz

    inv_cells = jnp.linalg.inv(cells)
    frac = jax.vmap(apply_mat3)(positions, inv_cells)       # [B, npa, 3]
    bin_pos = frac * cpd_xyz.astype(dtype)
    if origin is not None:
        bin_pos = bin_pos - jnp.asarray(origin, dtype=dtype).reshape(1, 1, 3)
    coords = jnp.floor(bin_pos).astype(INDEX_DTYPE)
    wrap = jnp.floor_divide(coords, cpd_xyz)
    wrapped = coords - wrap * cpd_xyz
    clamped = jnp.clip(coords, 0, cpd_xyz - 1)
    ccoords = jnp.where(pbc_arr[None, None, :], wrapped, clamped)
    aps = jnp.where(pbc_arr[None, None, :], wrap, 0)

    shift_cart = jax.vmap(apply_mat3)(aps.astype(dtype), cells)
    wpx = (positions[..., 0] - shift_cart[..., 0]).reshape(-1)
    wpy = (positions[..., 1] - shift_cart[..., 1]).reshape(-1)
    wpz = (positions[..., 2] - shift_cart[..., 2]).reshape(-1)

    lin = ccoords[..., 0] + cx * (ccoords[..., 1] + cy * ccoords[..., 2])
    sys_id = jnp.arange(B, dtype=INDEX_DTYPE)
    lin_g = (lin + sys_id[:, None] * ncells).reshape(-1)    # compound key

    n_tot = B * npa
    iota = jnp.arange(n_tot, dtype=INDEX_DTYPE)
    sorted_lin, order, spx, spy, spz = jax.lax.sort(
        (lin_g, iota, wpx, wpy, wpz), num_keys=1, is_stable=True)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_lin[1:] != sorted_lin[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, iota, 0))
    rank_sorted = iota - run_start
    sys_sorted = sorted_lin // jnp.asarray(ncells, INDEX_DTYPE)
    counts_max = jax.ops.segment_max(
        rank_sorted, sys_sorted, num_segments=B,
        indices_are_sorted=True) + 1

    # per-atom LOCAL slot ids (system-relative, as the vmapped build makes)
    local_lin = sorted_lin - sys_sorted * ncells
    flat = jnp.zeros((n_tot,), INDEX_DTYPE).at[order].set(
        jnp.where(rank_sorted >= cap, ncells * cap,
                  local_lin * cap + rank_sorted)).reshape(B, npa)

    counts = jnp.zeros((B * ncells,), INDEX_DTYPE).at[lin_g].add(1)
    starts = jnp.cumsum(counts) - counts
    ends = starts + counts
    valid = (jnp.arange(cap, dtype=INDEX_DTYPE)[None, :] < counts[:, None])
    # local atom ids (order mod npa) so ext_aid matches the per-system build
    order_sys = order // jnp.asarray(npa, INDEX_DTYPE)
    order_local = (order - order_sys * npa).astype(dtype)

    # slot planes via cap x per-payload 1-D monotone takes at starts + r
    # (clamped to the run end — min of two monotone sequences stays
    # monotone, so indices_are_sorted holds per call) instead of one
    # [slots] row take of a [n+cap, 4] payload matrix.
    def slot_take(payload, fill):
        v = jnp.concatenate([payload, jnp.full((1,), fill, payload.dtype)])
        cols = [jnp.take(v, jnp.minimum(starts + r, ends),
                         indices_are_sorted=True) for r in range(cap)]
        out = jnp.stack(cols, axis=-1)                    # [B*ncells, cap]
        return jnp.where(valid, out, fill).reshape(B, cz, cy, cx, cap)

    g_px = slot_take(spx, 0.0)
    g_py = slot_take(spy, 0.0)
    g_pz = slot_take(spz, 0.0)
    g_aid = slot_take(order_local, float(npa)).astype(INDEX_DTYPE)
    g_valid = valid.reshape(B, cz, cy, cx, cap)

    # per-SYSTEM park iota (systems never interact; matches vmapped build)
    slot_iota = jnp.arange(ncells * cap, dtype=dtype).reshape(
        1, cz, cy, cx, cap)
    park = jnp.where(g_valid, 0.0, DISPLACE + slot_iota * DISPLACE_SPACING)
    g_px = g_px + park

    def extend(plane, periodic_fill):
        out = plane
        pads = [(rz, rz), (ry, ry), (rx, rx)]
        for ax, (p, is_pbc) in enumerate(
                zip(pads, (pbc_arr[2], pbc_arr[1], pbc_arr[0]))):
            cfg = [(0, 0)] * out.ndim
            cfg[ax + 1] = p            # axis 0 is the batch axis
            wrapped_p = jnp.pad(out, cfg, mode="wrap")
            const_p = jnp.pad(out, cfg, mode="constant",
                              constant_values=periodic_fill)
            out = jnp.where(is_pbc, wrapped_p, const_p)
        return out

    ext_px = extend(g_px, DISPLACE)
    ext_py = extend(g_py, 0.0)
    ext_pz = extend(g_pz, 0.0)
    ext_valid = extend(g_valid, False)
    ext_aid = extend(g_aid, npa)

    ez_dim = (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx)
    ez = jax.lax.broadcasted_iota(INDEX_DTYPE, ez_dim, 0)
    ey = jax.lax.broadcasted_iota(INDEX_DTYPE, ez_dim, 1)
    ex = jax.lax.broadcasted_iota(INDEX_DTYPE, ez_dim, 2)
    sz = jnp.floor_divide(ez - rz, jnp.asarray(cz, INDEX_DTYPE))
    sy = jnp.floor_divide(ey - ry, jnp.asarray(cy, INDEX_DTYPE))
    sx = jnp.floor_divide(ex - rx, jnp.asarray(cx, INDEX_DTYPE))
    sxf, syf, szf = sx.astype(dtype), sy.astype(dtype), sz.astype(dtype)
    c = cells.reshape(B, 1, 1, 1, 3, 3)
    shx = (sxf * c[..., 0, 0] + syf * c[..., 1, 0] + szf * c[..., 2, 0])
    shy = (sxf * c[..., 0, 1] + syf * c[..., 1, 1] + szf * c[..., 2, 1])
    shz = (sxf * c[..., 0, 2] + syf * c[..., 1, 2] + szf * c[..., 2, 2])
    ext_px = ext_px + shx[..., None]
    ext_py = ext_py + shy[..., None]
    ext_pz = ext_pz + shz[..., None]
    code = jnp.broadcast_to(pack_shifts(sx, sy, sz), (B,) + ez_dim)

    return AtomGrid(
        ext_px=ext_px,
        ext_py=ext_py,
        ext_pz=ext_pz,
        ext_valid=ext_valid,
        ext_aid=ext_aid,
        ext_shift_code=code,
        flat_slot=flat,
        dims=dims,
        radius=radius,
        cap=cap,
        counts_max=counts_max,
    )


def scatter_to_grid(grid: AtomGrid, values, fill=0.0):
    """Scatter a per-atom array into interior grid layout [Cz, Cy, Cx, cap]."""
    cz, cy, cx = grid.dims
    buf = jnp.full((cz * cy * cx * grid.cap + 1,), fill, dtype=values.dtype)
    return buf.at[grid.flat_slot].set(values)[:-1].reshape(cz, cy, cx, grid.cap)


def gather_from_grid(grid: AtomGrid, plane):
    """Read per-atom values back out of an interior grid plane."""
    return plane.reshape(-1)[jnp.minimum(grid.flat_slot, plane.size - 1)]


def gather_rows_from_grid(grid: AtomGrid, planes):
    """One [slots, k] row gather for k interior planes -> k per-atom arrays.

    One row gather of the stacked planes replaces k separate per-atom
    gathers — used by every multi-output epilogue (forces + energy/CN).
    """
    stacked = jnp.stack([p.reshape(-1) for p in planes], axis=-1)
    rows = stacked[jnp.minimum(grid.flat_slot, stacked.shape[0] - 1)]
    return tuple(rows[..., i] for i in range(len(planes)))


def use_slot_gather(n: int, nslots: int) -> bool:
    """Static heuristic: build slot planes by gather or by scatter.

    The slot->atom row GATHER scales with the slot count; the atom->slot
    row SCATTER scales with the atom count but takes XLA's conservative
    random-destination scatter lowering.  Large systems gather unless
    the slot slack is extreme; small (typically vmapped) systems scatter.
    The thresholds were tuned on an earlier accelerator and keep their
    behaviour until they are measured again on the GPU.

    ``NVALCHEMIOPS_SLOT_GATHER=0|1`` (trace-time) forces the answer, so
    both forms can be measured at one config in separate processes.
    """
    env = os.environ.get("NVALCHEMIOPS_SLOT_GATHER")
    if env in ("0", "1"):
        return env == "1"
    return n >= 32768 and nslots <= 6 * n


def scatter_rows_to_grid(grid: AtomGrid, values_list, fill=0.0):
    """One [slots, k] row gather (or scatter) for k per-atom arrays.

    Slot -> atom is already materialized in the aid plane (trash slots
    point one past the end), so at scale the planes are a single row
    GATHER from the fill-padded value rows instead of a random-destination
    row scatter; small/slack-heavy cases keep the scatter (see
    :func:`use_slot_gather`).  All values are cast to a
    common dtype (the first array's); integer planes up to 2^24 survive
    a float round-trip exactly.
    """
    cz, cy, cx = grid.dims
    dtype = values_list[0].dtype
    k = len(values_list)
    n = values_list[0].shape[0]
    nslots = cz * cy * cx * grid.cap
    vals = jnp.stack([jnp.asarray(v, dtype) for v in values_list], axis=-1)
    if use_slot_gather(n, nslots):
        padded = jnp.concatenate(
            [vals, jnp.full((1, k), fill, dtype=dtype)], axis=0)
        aid = _interior(grid, grid.ext_aid).reshape(-1)
        planes = padded[aid].reshape(cz, cy, cx, grid.cap, k)
    else:
        buf = jnp.full((nslots + 1, k), fill, dtype=dtype)
        planes = buf.at[grid.flat_slot].set(vals)[:-1].reshape(
            cz, cy, cx, grid.cap, k)
    return tuple(planes[..., i] for i in range(k))


def _interior(grid: AtomGrid, ext_plane):
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    return ext_plane[rz:rz + cz, ry:ry + cy, rx:rx + cx]


def grid_pair_reduce(grid: AtomGrid, kernel, init, extra_ext_planes=(),
                     extra_own_planes=()):
    """Scan the (2R+1)^3 offset sweep, reducing per-own-atom quantities.

    ``kernel(carry, own, cand, offset_index)`` receives:
      own:  dict(px, py, pz, valid, aid, *extra_own) — interior planes,
            each [Cz, Cy, Cx, cap]
      cand: dict(px, py, pz, valid, aid, code, *extra_ext) — candidate
            planes at the current offset, same shapes (+ code broadcast
            [Cz, Cy, Cx, 1])
    and returns the updated carry (typically per-own-slot accumulators).
    The pair block for (own slot a, candidate slot b) is formed inside the
    kernel by broadcasting ``own[..., :, None]`` vs ``cand[..., None, :]``.
    """
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    cap = grid.cap

    own = {
        "px": _interior(grid, grid.ext_px),
        "py": _interior(grid, grid.ext_py),
        "pz": _interior(grid, grid.ext_pz),
        "valid": _interior(grid, grid.ext_valid),
        "aid": _interior(grid, grid.ext_aid),
    }
    for name, plane in extra_own_planes:
        own[name] = plane

    offsets = [
        (dz, dy, dx)
        for dz in range(-rz, rz + 1)
        for dy in range(-ry, ry + 1)
        for dx in range(-rx, rx + 1)
    ]
    off_arr = jnp.asarray(offsets, dtype=INDEX_DTYPE)  # [O, 3] (dz, dy, dx)

    ext = {
        "px": grid.ext_px,
        "py": grid.ext_py,
        "pz": grid.ext_pz,
        "valid": grid.ext_valid,
        "aid": grid.ext_aid,
    }
    for name, plane in extra_ext_planes:
        ext[name] = plane

    def body(carry, oi):
        d = off_arr[oi]
        z0 = d[0] + rz
        y0 = d[1] + ry
        x0 = d[2] + rx
        cand = {
            name: jax.lax.dynamic_slice(
                plane, (z0, y0, x0, jnp.zeros((), INDEX_DTYPE)),
                (cz, cy, cx, plane.shape[-1]),
            )
            for name, plane in ext.items()
        }
        code = jax.lax.dynamic_slice(
            grid.ext_shift_code, (z0, y0, x0), (cz, cy, cx)
        )
        cand["code"] = code[..., None]
        carry = kernel(carry, own, cand, oi)
        return carry, None

    carry, _ = jax.lax.scan(body, init, jnp.arange(len(offsets), dtype=INDEX_DTYPE))
    return carry


@partial(jax.jit, static_argnames=("dims", "radius", "cap"))
def _neighbor_count_impl(grid: AtomGrid, cutoff, dims, radius, cap):
    dtype = grid.ext_px.dtype
    cutoff_sq = jnp.asarray(cutoff, dtype=dtype) ** 2

    def kern(counts, own, cand, oi):
        dx = cand["px"][..., None, :] - own["px"][..., :, None]
        dy = cand["py"][..., None, :] - own["py"][..., :, None]
        dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
        d2 = dx * dx + dy * dy + dz * dz
        # parked empty slots (build_atom_grid) fail the distance test on
        # their own — no validity compares needed
        pair_ok = (d2 < cutoff_sq) & (d2 > 1e-24)
        # exclude identical atom (same aid, zero shift handled by d2 > 0)
        self_pair = own["aid"][..., :, None] == cand["aid"][..., None, :]
        zero_code = cand["code"][..., None] == pack_shifts(
            jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE)
        )
        pair_ok &= ~(self_pair & zero_code)
        return counts + jnp.sum(pair_ok, axis=-1).astype(INDEX_DTYPE)

    cz, cy, cx = dims
    init = jnp.zeros((cz, cy, cx, cap), INDEX_DTYPE)
    return grid_pair_reduce(grid, kern, init)


def grid_neighbor_count(grid: AtomGrid, cutoff, num_atoms: int):
    """Per-atom neighbor counts straight from the grid (validation helper)."""
    counts_plane = _neighbor_count_impl(
        grid, cutoff, grid.dims, grid.radius, grid.cap
    )
    return gather_from_grid(grid, counts_plane)


@partial(jax.jit, static_argnames=("dims", "radius", "cap"))
def _cn_impl(grid: AtomGrid, rcov_plane, cutoff, k1, dims, radius, cap,
             rcov_ext):
    dtype = grid.ext_px.dtype
    cutoff_sq = jnp.asarray(cutoff, dtype=dtype) ** 2

    def kern(cn, own, cand, oi):
        dx = cand["px"][..., None, :] - own["px"][..., :, None]
        dy = cand["py"][..., None, :] - own["py"][..., :, None]
        dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-24)
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        rc = own["rcov"][..., :, None] + cand["rcov"][..., None, :]
        f = 1.0 / (1.0 + jnp.exp(-k1 * (rc * inv_r - 1.0)))
        return cn + jnp.sum(jnp.where(ok, f, 0.0), axis=-1)

    cz, cy, cx = dims
    init = jnp.zeros((cz, cy, cx, cap), dtype)
    return grid_pair_reduce(
        grid, kern, init,
        extra_ext_planes=(("rcov", rcov_ext),),
        extra_own_planes=(("rcov", rcov_plane),),
    )


def grid_coordination_numbers(grid: AtomGrid, rcov_per_atom, cutoff, k1=16.0):
    """DFT-D3 coordination numbers computed on the grid."""
    rcov_plane = scatter_to_grid(grid, rcov_per_atom)
    rcov_ext = _extend_like(grid, rcov_plane, 0.0)
    cn_plane = _cn_impl(
        grid, rcov_plane, cutoff, jnp.asarray(k1, grid.ext_px.dtype),
        grid.dims, grid.radius, grid.cap, rcov_ext,
    )
    return gather_from_grid(grid, cn_plane)


def _extend_like(grid: AtomGrid, plane, fill):
    """Halo-extend an interior per-atom property plane (ghosts copy values)."""
    rz, ry, rx = grid.radius
    # property values are shift-independent: pure wrap/constant pad.
    out = plane
    # reconstruct pbc from where ghost cells are valid — instead just pad
    # wrap everywhere and mask with ext_valid at use sites.
    pads = [(rz, rz), (ry, ry), (rx, rx)]
    for ax, p in enumerate(pads):
        cfg = [(0, 0)] * plane.ndim
        cfg[ax] = p
        out = jnp.pad(out, cfg, mode="wrap")
    valid = grid.ext_valid
    if plane.ndim == 5:  # feature planes [.., cap, F]
        valid = valid[..., None]
    return jnp.where(valid, out, fill)


@partial(jax.jit, static_argnames=("cutoff", "alpha", "dims", "radius", "cap"))
def _coulomb_impl(grid: AtomGrid, q_plane, q_ext, cutoff, alpha, dims, radius, cap):
    """Symmetric half-space sweep: each pair computed once, j-side folded.

    ``cutoff``/``alpha`` are static so the undamped path never evaluates
    the erfc branch (the traced-``where`` version paid both branches on
    every pair slot); validity compares are gone entirely — parked empty
    slots (build_atom_grid) fail the distance test on their own.
    """
    dtype = grid.ext_px.dtype
    cutoff_sq = float(cutoff) ** 2
    alpha_t = float(alpha)
    from nvalchemiops_tpu.mathops.math import erfc_approx

    two_over_sqrt_pi = 1.1283791670955126
    cz, cy, cx = dims
    upper = row_home_mask(cap, radius[2])

    def kern(carry, own, cand, home):
        e, fx, fy, fz = carry
        dx = cand["px"][..., None, :] - own["px"][..., :, None]
        dy = cand["py"][..., None, :] - own["py"][..., :, None]
        dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-20)
        if home:
            ok &= upper
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        qq = own["q"][..., :, None] * cand["q"][..., None, :]
        if alpha_t > 0:
            r = jnp.where(ok, d2, 1.0) * inv_r
            ar = alpha_t * r
            erfc_ar = erfc_approx(ar)
            phi = erfc_ar * inv_r
            mag = (
                erfc_ar * inv_r + two_over_sqrt_pi * alpha_t * jnp.exp(-ar * ar)
            ) * inv_r * inv_r
        else:
            phi = inv_r
            mag = inv_r * inv_r * inv_r
        e_pair = jnp.where(ok, 0.5 * qq * phi, 0.0)
        coef = jnp.where(ok, qq * mag, 0.0)
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        e = e + jnp.sum(e_pair, axis=-1)
        fx = fx - jnp.sum(cfx, axis=-1)
        fy = fy - jnp.sum(cfy, axis=-1)
        fz = fz - jnp.sum(cfz, axis=-1)
        # j-side: same pair energy, opposite force
        deltas = (
            jnp.sum(e_pair, axis=-2),
            jnp.sum(cfx, axis=-2),
            jnp.sum(cfy, axis=-2),
            jnp.sum(cfz, axis=-2),
        )
        return (e, fx, fy, fz), deltas

    zeros = jnp.zeros((cz, cy, cx, cap), dtype)
    (e, fx, fy, fz), (e2, fx2, fy2, fz2) = grid_row_reduce_sym(
        grid, kern, (zeros, zeros, zeros, zeros), 4,
        extra_ext_planes=(("q", q_ext),),
        extra_own_planes=(("q", q_plane),),
    )
    return e + e2, fx + fx2, fy + fy2, fz + fz2


def grid_coulomb_energy_forces(grid: AtomGrid, charges, cutoff, alpha=0.0,
                               engine: str | None = None):
    """(Damped-)Coulomb per-atom energies and forces via the grid sweep.

    Same physics contract as coulomb.pair_energies_forces; self-image pairs
    (r -> 0) are excluded by the r^2 > 0 guard like the reference kernels'
    distance floor.  ``engine``: ``"xla"`` (the default and only engine,
    the symmetric row sweep); any other name raises ``ValueError``.
    """
    if engine not in (None, "xla"):
        raise ValueError(
            f"unknown grid Coulomb engine {engine!r}; expected 'xla'")
    q_plane = scatter_to_grid(grid, charges)
    q_ext = _extend_like(grid, q_plane, 0.0)
    e, fx, fy, fz = _coulomb_impl(
        grid, q_plane, q_ext, float(cutoff), float(alpha),
        grid.dims, grid.radius, grid.cap
    )
    energies, f1, f2, f3 = gather_rows_from_grid(grid, (e, fx, fy, fz))
    return energies, jnp.stack([f1, f2, f3], axis=-1)


def choose_grid_origin(positions, cell, pbc, dims):
    """Pick the bin-partition origin (xyz, bin units) minimizing occupancy.

    Tries the zero origin and the half-bin shift per axis (4 combinations
    over distinct axes): for near-crystalline systems, lattice planes that
    sit exactly on bin boundaries split their atoms across two bins under
    jitter, inflating the max occupancy that sizes every pair block.  Each
    candidate costs one cheap histogram (no grid build).  Returns
    ``(origin [3] np.ndarray, max_occupancy int)``.
    """
    dtype = positions.dtype
    cell_j = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    cz, cy, cx = dims
    cpd_xyz = jnp.asarray([cx, cy, cz], INDEX_DTYPE)
    # MUST match build_atom_grid's binning rule exactly: wrap on periodic
    # axes, clamp elsewhere — wrapping a non-periodic axis here undercounts
    # the edge bins and sizes ``cap`` below the real occupancy (silently
    # dropped atoms = missing pairs).
    pbc_j = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]

    @jax.jit
    def max_occ(origin):
        frac = apply_mat3(positions, jnp.linalg.inv(cell_j))
        bp = frac * cpd_xyz.astype(dtype) - origin.reshape(1, 3)
        coords = jnp.floor(bp).astype(INDEX_DTYPE)
        wrapped = coords - jnp.floor_divide(coords, cpd_xyz) * cpd_xyz
        clamped = jnp.clip(coords, 0, cpd_xyz - 1)
        ccoords = jnp.where(pbc_j[None, :], wrapped, clamped)
        lin = ccoords[:, 0] + cx * (ccoords[:, 1] + cy * ccoords[:, 2])
        counts = jnp.zeros((cx * cy * cz,), INDEX_DTYPE).at[lin].add(1)
        return jnp.max(counts)

    best = None
    for o in ([0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.0, 0.0],
              [0.0, 0.5, 0.5]):
        occ = int(jax.device_get(max_occ(jnp.asarray(o, dtype))))
        if best is None or occ < best[1]:
            best = (np.asarray(o), occ)
        if occ == best[1] and best[1] * len(positions) == 0:
            break
    return best


def row_sweep_slots(dims, radius, cap: int) -> int:
    """Candidate slots the symmetric row sweep visits for one geometry.

    ``ncells * cap^2 * ((rx+1) + n_half * (2rx+1))`` with ``n_half`` the
    half-space (z, y) offsets: the own-row band plus every other row's
    full x window.  This is the cost model :func:`choose_grid_geometry`
    minimizes.
    """
    rz, ry, rx = (int(r) for r in radius)
    n_half = ((2 * rz + 1) * (2 * ry + 1) - 1) // 2
    ncells = int(dims[0]) * int(dims[1]) * int(dims[2])
    return ncells * cap * cap * ((rx + 1) + n_half * (2 * rx + 1))


def choose_grid_geometry(positions, cell, pbc, cutoff: float,
                         dims_candidates=None):
    """Score dims x origin x capacity by row-sweep slot count; pick the best.

    Bin-count choices interact non-obviously with the occupancy
    distribution: a slightly coarser grid can have a much tighter max
    occupancy, and the sweep cost scales with cap^2.

    Searches per-axis bin counts {floor, floor-1} at anisotropic
    bins-per-cutoff combinations — (z, y) at 1-2x jointly, x at 1-4x
    independently (plus any explicit ``dims_candidates`` in (Cz, Cy, Cx)
    order).  Candidates are pre-scored with a mean-occupancy cap
    estimate, the best few get the real occupancy histogram
    (:func:`choose_grid_origin`), and the final pick minimizes
    :func:`row_sweep_slots` at the observed capacity.  Any candidate is a
    *valid* partition (physics is geometry-independent); this only picks
    the cheapest.
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell_np).T
    face = 1.0 / np.linalg.norm(inv_t, axis=1)          # xyz order
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1)[:3]
    cpd_max = np.maximum((face / cutoff).astype(np.int64), 1)
    n_atoms = int(positions.shape[0])

    cands = []
    for bzy in (1, 2):
        for bx_f in (1, 2, 3, 4):
            for delta in (0, -1):
                bpc = np.array([bx_f, bzy, bzy])
                cpd = np.maximum(bpc * cpd_max + delta, 1)
                cands.append((int(cpd[2]), int(cpd[1]), int(cpd[0])))
    if dims_candidates:
        cands.extend(tuple(int(v) for v in d) for d in dims_candidates)
    seen, uniq = set(), []
    for d in cands:
        if d not in seen:
            seen.add(d)
            uniq.append(d)

    def geom_score(dims, cap):
        """(row-sweep slots or None if invalid, radius) — lower wins."""
        cpd_xyz = np.array([dims[2], dims[1], dims[0]], dtype=np.int64)
        radius = np.ceil(cutoff * cpd_xyz / face).astype(np.int64)
        if (radius[pbc_np] > cpd_xyz[pbc_np]).any():
            return None, None  # halo would wrap onto itself; invalid
        radius_zyx = (int(radius[2]), int(radius[1]), int(radius[0]))
        return row_sweep_slots(dims, radius_zyx, cap), radius_zyx

    # pre-score every candidate with a mean-occupancy capacity estimate
    # (the real histogram costs device roundtrips; only the best few get
    # one).  The estimate ranks candidates; the final pick re-scores
    # with the observed capacity.
    pre = []
    for dims in uniq:
        ncells = dims[0] * dims[1] * dims[2]
        mean_occ = n_atoms / max(ncells, 1)
        cap_est = max(mean_occ / 0.7,
                      mean_occ + 5.0 * np.sqrt(mean_occ + 1.0))
        cap_est = int(np.ceil(max(cap_est, 8.0) / 8)) * 8
        key, radius = geom_score(dims, cap_est)
        if key is not None:
            pre.append((key, dims))
    pre.sort(key=lambda kv: kv[0])

    # top-8: the pre-score's Poisson cap margin is pessimistic exactly
    # for the fine-binned (low-occupancy) candidates that win on real
    # crystals, so the histogram stage must be wide enough to catch them
    best = None
    for _, dims in pre[:8]:
        origin_np, occ = choose_grid_origin(positions, cell, pbc, dims)
        cap = max(int(np.ceil((occ + 1) / 8)) * 8,
                  int(np.ceil(occ * 1.02 / 8)) * 8)
        key, radius = geom_score(dims, cap)
        if key is None:
            continue
        if best is None or key < best[0]:
            origin = origin_np if np.any(origin_np != 0.0) else None
            best = (key, dims, radius, cap, origin)
    if best is None:
        raise ValueError(
            "no valid grid geometry for this cell/cutoff (radius > cells "
            "per dimension on a periodic axis); use the naive path"
        )
    return best[1], best[2], best[3], best[4]


def build_atom_grid_auto(positions, cell, pbc, cutoff: float,
                         target_occupancy: float = 0.66,
                         bins_per_cutoff: int = 1,
                         optimize_origin: bool = True,
                         optimize_geometry: bool = True):
    """Estimate geometry, pick an origin, build with a tight capacity.

    Host syncs (reading occupancy histograms) — same estimate-then-check
    split the reference uses for its cell-list sizes (cell_list.py:639-724).
    Sweep cost scales ~cap^2, so the observed-occupancy capacity (and the
    origin search that lowers it for crystals) matters more than the extra
    build.  ``optimize_geometry`` (default) searches nearby bin counts at
    1-4x bins-per-cutoff with :func:`choose_grid_geometry` (one cheap
    histogram per candidate) and scores them by row-sweep slot count;
    pass ``optimize_geometry=False`` to keep the single
    ``estimate_grid_geometry`` partition (``target_occupancy`` /
    ``bins_per_cutoff`` apply only to that path).
    """
    n = positions.shape[0]
    if optimize_geometry:
        dims, radius, cap, origin_np = choose_grid_geometry(
            positions, cell, pbc, cutoff)
        origin = (jnp.asarray(origin_np, positions.dtype)
                  if origin_np is not None else None)
        g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                            origin=origin)
        true_occ = int(jax.device_get(g.counts_max))
        if true_occ > cap:
            cap = int(np.ceil((true_occ + 1) / 8)) * 8
            g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                                origin=origin)
        return g
    dims, radius, cap = estimate_grid_geometry(
        cell, pbc, cutoff, n, target_occupancy=target_occupancy,
        bins_per_cutoff=bins_per_cutoff,
    )
    origin = None
    if optimize_origin:
        origin_np, observed = choose_grid_origin(positions, cell, pbc, dims)
        if np.any(origin_np != 0.0):
            origin = jnp.asarray(origin_np, positions.dtype)
    else:
        g = build_atom_grid(positions, cell, pbc, dims, radius, cap)
        observed = int(jax.device_get(g.counts_max))
    # cap = observed max occupancy with one-slot-then-round-to-8 headroom
    cap = max(int(np.ceil((observed + 1) / 8)) * 8,
              int(np.ceil(observed * 1.02 / 8)) * 8)
    g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                        origin=origin)
    # estimate-then-CHECK (reference cell_list.py:639-724 splits the same
    # way): if the observed occupancy disagreed with the real build (e.g.
    # positions moved between the histogram and the build), rebuild with
    # the true capacity rather than silently dropping atoms.
    true_occ = int(jax.device_get(g.counts_max))
    if true_occ > cap:
        cap = int(np.ceil((true_occ + 1) / 8)) * 8
        g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                            origin=origin)
    return g


# ---------------------------------------------------------------------------
# Symmetric (half-space) pair sweep
# ---------------------------------------------------------------------------
#
# The full-space sweep touches every pair twice (once from each side).  The
# symmetric sweep walks only the half-space of cell offsets, computes each
# pair block once, and accumulates the j-side contribution into an extended
# (halo) accumulator plane; halo regions then fold back onto their interior
# source cells with pure slice adds — the atomic-free equivalent of the
# reference's symmetric atomic insertion (neighbor_utils.py:70-147), with the 2x pair
# saving and no atomics.


def _halfspace_offsets(radius):
    """Half-space offsets (dz, dy, dx), home (0,0,0) excluded."""
    rz, ry, rx = radius
    offs = []
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                if dz > 0 or (dz == 0 and dy > 0) or (dz == 0 and dy == 0 and dx > 0):
                    offs.append((dz, dy, dx))
    return np.asarray(offs, dtype=np.int32)


def fold_halo(grid: AtomGrid, ext_acc):
    """Fold an extended accumulator's halo back onto the interior (wrap)."""
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    a = ext_acc
    # fold z
    if rz:
        core = a[rz:rz + cz]
        core = core.at[:rz].add(a[rz + cz:rz + cz + rz])
        core = core.at[cz - rz:].add(a[0:rz])
        a = core
    else:
        a = a[0:cz]
    if ry:
        core = a[:, ry:ry + cy]
        core = core.at[:, :ry].add(a[:, ry + cy:ry + cy + ry])
        core = core.at[:, cy - ry:].add(a[:, 0:ry])
        a = core
    else:
        a = a[:, 0:cy]
    if rx:
        core = a[:, :, rx:rx + cx]
        core = core.at[:, :, :rx].add(a[:, :, rx + cx:rx + cx + rx])
        core = core.at[:, :, cx - rx:].add(a[:, :, 0:rx])
        a = core
    else:
        a = a[:, :, 0:cx]
    return a


def grid_pair_reduce_sym(grid: AtomGrid, kernel, init, num_ext_acc: int,
                         extra_ext_planes=(), extra_own_planes=()):
    """Half-space offset sweep with symmetric accumulation.

    ``kernel(carry, own, cand, home)`` must return
    ``(carry, cand_deltas)`` where ``cand_deltas`` is a tuple of
    ``num_ext_acc`` arrays [Cz, Cy, Cx, cap] holding the j-side
    contributions of this offset's pair blocks (use an upper-triangle slot
    mask when ``home`` is True — the home block pairs each cell with
    itself).  Returns ``(carry, folded_ext_accumulators)`` where each
    accumulator is the folded interior [Cz, Cy, Cx, cap] sum of all j-side
    deltas.
    """
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    cap = grid.cap
    dtype = grid.ext_px.dtype

    own = {
        "px": _interior(grid, grid.ext_px),
        "py": _interior(grid, grid.ext_py),
        "pz": _interior(grid, grid.ext_pz),
        "valid": _interior(grid, grid.ext_valid),
        "aid": _interior(grid, grid.ext_aid),
    }
    for name, plane in extra_own_planes:
        own[name] = plane

    ext = {
        "px": grid.ext_px,
        "py": grid.ext_py,
        "pz": grid.ext_pz,
        "valid": grid.ext_valid,
        "aid": grid.ext_aid,
    }
    for name, plane in extra_ext_planes:
        ext[name] = plane

    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx
    ext_acc = tuple(
        jnp.zeros((ez, ey, ex, cap), dtype) for _ in range(num_ext_acc)
    )

    # home block (offset 0): interior vs interior, upper-triangle pairs
    home_cand = {name: _interior(grid, plane) for name, plane in ext.items()}
    home_cand["code"] = jnp.zeros((cz, cy, cx, 1), INDEX_DTYPE) + pack_shifts(
        jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE)
    )
    carry, deltas = kernel(init, own, home_cand, True)
    ext_acc = tuple(
        acc.at[rz:rz + cz, ry:ry + cy, rx:rx + cx].add(d)
        for acc, d in zip(ext_acc, deltas)
    )

    offs = _halfspace_offsets(grid.radius)
    off_arr = jnp.asarray(offs, dtype=INDEX_DTYPE)

    def body(state, oi):
        carry, ext_acc = state
        d = off_arr[oi]
        z0 = d[0] + rz
        y0 = d[1] + ry
        x0 = d[2] + rx
        cand = {
            name: jax.lax.dynamic_slice(
                plane, (z0, y0, x0, jnp.zeros((), INDEX_DTYPE)),
                (cz, cy, cx, plane.shape[-1]),
            )
            for name, plane in ext.items()
        }
        code = jax.lax.dynamic_slice(grid.ext_shift_code, (z0, y0, x0), (cz, cy, cx))
        cand["code"] = code[..., None]
        carry, deltas = kernel(carry, own, cand, False)
        new_acc = []
        for acc, delta in zip(ext_acc, deltas):
            old = jax.lax.dynamic_slice(
                acc, (z0, y0, x0, jnp.zeros((), INDEX_DTYPE)), (cz, cy, cx, cap)
            )
            acc = jax.lax.dynamic_update_slice(
                acc, old + delta, (z0, y0, x0, jnp.zeros((), INDEX_DTYPE))
            )
            new_acc.append(acc)
        return (carry, tuple(new_acc)), None

    (carry, ext_acc), _ = jax.lax.scan(
        body, (carry, ext_acc), jnp.arange(offs.shape[0], dtype=INDEX_DTYPE)
    )
    folded = tuple(fold_halo(grid, acc) for acc in ext_acc)
    return carry, folded


# ---------------------------------------------------------------------------
# Row-merged symmetric sweep (x-axis folded into the candidate window)
# ---------------------------------------------------------------------------
#
# The per-cell sweep pairs [cap x cap] blocks, whose small trailing dim
# (cap ~ 40) tiles the bilinear matmuls poorly.  The row sweep instead
# pairs each cell against a
# whole x-window of (2Rx+1) cells at once: candidate planes are a concat of
# x-shifted static slices with trailing dim (2Rx+1)*cap, so the (dz, dy)
# offset loop shrinks from (2R+1)^3/2 offsets to (2Rz+1)(2Ry+1)/2 and every
# pair block is wide.  Offsets are unrolled Python loops with fully
# static slice indices (no scan, no dynamic_slice) — XLA schedules them as
# one straight-line program.


def row_home_mask(cap: int, rx: int):
    """Pair-once mask for the home row window [1,1,1,cap,(rx+1)*cap].

    The home window holds chunks dxoff = 0..rx; the dxoff = 0 chunk is the
    cell paired with itself (keep i < j), chunks dxoff > 0 are distinct
    cells seen only from the left side (keep all).
    """
    slot_i = jax.lax.broadcasted_iota(INDEX_DTYPE, (cap, (rx + 1) * cap), 0)
    slot_j = jax.lax.broadcasted_iota(INDEX_DTYPE, (cap, (rx + 1) * cap), 1)
    keep = (slot_j >= cap) | (slot_i < slot_j)
    return keep.reshape(1, 1, 1, cap, (rx + 1) * cap)


def grid_row_reduce_sym(grid: AtomGrid, kernel, init, num_ext_acc: int,
                        extra_ext_planes=(), extra_own_planes=()):
    """Half-space (dz, dy) sweep with x-merged candidate windows.

    ``kernel(carry, own, cand, home)`` sees candidate planes of trailing
    dim W = (2*Rx+1)*cap (home: (Rx+1)*cap) and must apply
    :func:`row_home_mask` when ``home`` is True.  Contract otherwise
    identical to :func:`grid_pair_reduce_sym`: returns ``(carry, deltas)``
    with ``num_ext_acc`` j-side delta arrays [Cz, Cy, Cx, W]; the sweep
    scatters the window chunks back and returns the folded interior
    accumulators.
    """
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    cap = grid.cap
    dtype = grid.ext_px.dtype

    own = {
        "px": _interior(grid, grid.ext_px),
        "py": _interior(grid, grid.ext_py),
        "pz": _interior(grid, grid.ext_pz),
        "valid": _interior(grid, grid.ext_valid),
        "aid": _interior(grid, grid.ext_aid),
    }
    for name, plane in extra_own_planes:
        own[name] = plane

    ext = {
        "px": grid.ext_px,
        "py": grid.ext_py,
        "pz": grid.ext_pz,
        "valid": grid.ext_valid,
        "aid": grid.ext_aid,
    }
    for name, plane in extra_ext_planes:
        ext[name] = plane

    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx
    ext_acc = [
        jnp.zeros((ez, ey, ex, cap), dtype) for _ in range(num_ext_acc)
    ]

    def window(plane, z0, y0, chunks):
        # concat along the slot axis (axis 3) so extra planes may carry a
        # trailing feature axis [.., cap, F]
        return jnp.concatenate(
            [plane[z0:z0 + cz, y0:y0 + cy, c:c + cx] for c in chunks],
            axis=3,
        )

    def run_offset(carry, z0, y0, chunks, home):
        cand = {name: window(plane, z0, y0, chunks) for name, plane in ext.items()}
        code = jnp.stack(
            [grid.ext_shift_code[z0:z0 + cz, y0:y0 + cy, c:c + cx]
             for c in chunks],
            axis=-1,
        )
        cand["code"] = jnp.repeat(code, cap, axis=-1)
        carry, deltas = kernel(carry, own, cand, home)
        for k, delta in enumerate(deltas):
            d = delta.reshape(cz, cy, cx, len(chunks), cap)
            acc = ext_acc[k]
            for ci, c in enumerate(chunks):
                acc = acc.at[z0:z0 + cz, y0:y0 + cy, c:c + cx].add(d[..., ci, :])
            ext_acc[k] = acc
        return carry

    # home row: dz = dy = 0, right-side x chunks only (dxoff 0..rx)
    carry = run_offset(init, rz, ry, list(range(rx, 2 * rx + 1)), True)

    # half-space (dz, dy) offsets: full x window (dxoff -rx..rx)
    full_chunks = list(range(2 * rx + 1))
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            if dz > 0 or (dz == 0 and dy > 0):
                carry = run_offset(carry, dz + rz, dy + ry, full_chunks, False)

    folded = tuple(fold_halo(grid, acc) for acc in ext_acc)
    return carry, folded
