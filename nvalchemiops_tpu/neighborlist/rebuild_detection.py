# SPDX-License-Identifier: Apache-2.0
"""MD-loop rebuild-skip logic for cached neighbor structures.

JAX counterpart of ``nvalchemiops/neighborlist/rebuild_detection.py``
(kernels at rebuild_detection.py:36-250, public API at :336-633).  The
reference launches early-exit Warp kernels; here the whole check is a tiny
fused reduction, so these are plain jitted functions returning a boolean
array (device-resident, ``torch.compile``-style graph friendly) plus
host-``bool`` conveniences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE

__all__ = [
    "cell_list_needs_rebuild",
    "neighbor_list_needs_rebuild",
    "check_cell_list_rebuild_needed",
    "check_neighbor_list_rebuild_needed",
]


@jax.jit
def cell_list_needs_rebuild(
    current_positions,
    atom_to_cell_mapping,
    cells_per_dimension,
    cell,
    pbc,
):
    """True if any atom now maps to a different spatial cell.

    Recomputes each atom's (wrapped/clamped) cell coordinates with the stored
    grid and compares against ``atom_to_cell_mapping``
    (reference: rebuild_detection.py:36-121, :336-455).

    Returns a shape-(1,) bool array.
    """
    dtype = current_positions.dtype
    cell = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    pbc_arr = jnp.asarray(pbc, dtype=bool).reshape(-1)[:3]
    cpd = jnp.asarray(cells_per_dimension, dtype=INDEX_DTYPE).reshape(3)

    from nvalchemiops_tpu.mathops.math import apply_mat3
    frac = apply_mat3(current_positions, jnp.linalg.inv(cell))
    coords = jnp.floor(frac * cpd.astype(dtype)).astype(INDEX_DTYPE)
    wrap = jnp.floor_divide(coords, cpd)
    wrapped = coords - wrap * cpd
    clamped = jnp.clip(coords, 0, cpd - 1)
    new_coords = jnp.where(pbc_arr[None, :], wrapped, clamped)
    changed = jnp.any(new_coords != atom_to_cell_mapping)
    return changed.reshape(1)


@jax.jit
def neighbor_list_needs_rebuild(
    reference_positions,
    current_positions,
    skin_distance_threshold,
):
    """True if any atom moved farther than the skin distance.

    (reference: rebuild_detection.py:168-250, :457-498).  Returns a
    shape-(1,) bool array.
    """
    delta = current_positions - reference_positions
    disp_sq = jnp.sum(delta * delta, axis=-1)
    thresh = jnp.asarray(skin_distance_threshold, dtype=disp_sq.dtype)
    return jnp.any(disp_sq > thresh * thresh).reshape(1)


def check_cell_list_rebuild_needed(
    cells_per_dimension,
    neighbor_search_radius,
    atom_periodic_shifts,
    atom_to_cell_mapping,
    atoms_per_cell_count,
    cell_atom_start_indices,
    cell_atom_list,
    current_positions,
    current_cell,
    current_pbc,
    cutoff: float,
) -> bool:
    """Host-bool convenience wrapper (reference: rebuild_detection.py:505-577)."""
    del (
        neighbor_search_radius,
        atom_periodic_shifts,
        atoms_per_cell_count,
        cell_atom_start_indices,
        cell_atom_list,
        cutoff,
    )
    flag = cell_list_needs_rebuild(
        current_positions,
        atom_to_cell_mapping,
        cells_per_dimension,
        current_cell,
        current_pbc,
    )
    return bool(jax.device_get(flag)[0])


def check_neighbor_list_rebuild_needed(
    reference_positions,
    current_positions,
    skin_distance_threshold: float,
) -> bool:
    """Host-bool convenience wrapper (reference: rebuild_detection.py:579-633)."""
    flag = neighbor_list_needs_rebuild(
        reference_positions, current_positions, skin_distance_threshold
    )
    return bool(jax.device_get(flag)[0])
