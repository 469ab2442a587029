# SPDX-License-Identifier: Apache-2.0
"""Brute-force O(N^2) neighbor list for batched (concatenated) systems.

JAX counterpart of ``nvalchemiops/neighborlist/batch_naive.py``
(kernels at batch_naive.py:37-210, wrapper at batch_naive.py:480-763).
Systems are concatenated along the atom axis with ``batch_idx`` routing;
the streaming engine masks cross-system pairs and Cartesianizes shifts with
each pair's own cell.  The shift table is the union (max per dimension) of
the per-system shift ranges — shifts beyond a system's own range cannot pass
the distance test, so no per-system shift masking is needed.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist._streaming import streaming_pair_search
from nvalchemiops_tpu.neighborlist.naive import _resolve_max_neighbors
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    compute_naive_num_shifts,
    expand_full_shifts,
    expand_naive_shifts,
    get_neighbor_list_from_neighbor_matrix,
    prepare_batch_idx_ptr,
)

__all__ = ["batch_naive_neighbor_list"]


def batch_naive_neighbor_list(
    positions,
    cutoff: float,
    pbc=None,
    cell=None,
    batch_idx=None,
    batch_ptr=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    neighbor_matrix=None,
    max_atoms_per_system: int | None = None,
    **_ignored,
):
    """Batched brute-force neighbor matrix over concatenated systems.

    ``cell`` is [num_systems, 3, 3] and ``pbc`` [num_systems, 3] (or [3],
    broadcast).  Returns the same patterns as
    :func:`~nvalchemiops_tpu.neighborlist.naive.naive_neighbor_list`.
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms

    batch_idx, batch_ptr = prepare_batch_idx_ptr(batch_idx, batch_ptr, total_atoms)
    periodic = (
        pbc is not None and cell is not None and bool(np.asarray(pbc).any())
    )
    if periodic:
        cell_b = jnp.asarray(cell)
        if cell_b.ndim == 2:
            cell_b = cell_b.reshape(1, 3, 3)
        shift_range, _, _ = compute_naive_num_shifts(cell_b, cutoff, pbc)
        union_range = shift_range.max(axis=0)
        shifts = jnp.asarray(
            expand_naive_shifts(union_range)
            if half_fill
            else expand_full_shifts(union_range)
        )
    else:
        num_systems = int(batch_ptr.shape[0]) - 1
        cell_b = jnp.broadcast_to(
            jnp.eye(3, dtype=positions.dtype), (max(num_systems, 1), 3, 3)
        )
        shifts = jnp.zeros((1, 3), dtype=INDEX_DTYPE)

    k = _resolve_max_neighbors(
        max_neighbors, neighbor_matrix, cutoff, total_atoms * int(shifts.shape[0])
    )

    nm, num, sh = streaming_pair_search(
        positions,
        cell_b,
        shifts,
        jnp.asarray(cutoff, dtype=positions.dtype) ** 2,
        k,
        batch_idx=batch_idx,
        half_fill=half_fill,
        fill_value=int(fill_value),
        batched=True,
    )

    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh if periodic else None, fill_value=int(fill_value)
        )
    if periodic:
        return nm, num, sh
    return nm, num
