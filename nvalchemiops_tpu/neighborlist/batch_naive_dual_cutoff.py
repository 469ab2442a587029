# SPDX-License-Identifier: Apache-2.0
"""Dual-cutoff brute-force neighbor lists for batched systems.

JAX counterpart of ``nvalchemiops/neighborlist/batch_naive_dual_cutoff.py``
(kernels at batch_naive_dual_cutoff.py:36-297, wrapper at :592-1000).
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

__all__ = ["batch_naive_neighbor_list_dual_cutoff"]


def batch_naive_neighbor_list_dual_cutoff(
    positions,
    cutoff: float,
    cutoff2: float,
    pbc=None,
    cell=None,
    batch_idx=None,
    batch_ptr=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    max_neighbors2: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix2=None,
    **_ignored,
):
    """Batched single-pass dual-cutoff neighbor matrices.

    Same return patterns as
    :func:`~nvalchemiops_tpu.neighborlist.naive_dual_cutoff.naive_neighbor_list_dual_cutoff`.
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    batch_idx, batch_ptr = prepare_batch_idx_ptr(batch_idx, batch_ptr, total_atoms)
    periodic = pbc is not None and cell is not None and bool(np.asarray(pbc).any())

    shift_cutoff = max(float(cutoff), float(cutoff2))
    if periodic:
        cell_b = jnp.asarray(cell)
        if cell_b.ndim == 2:
            cell_b = cell_b.reshape(1, 3, 3)
        shift_range, _, _ = compute_naive_num_shifts(cell_b, shift_cutoff, pbc)
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

    cand = total_atoms * int(shifts.shape[0])
    k1 = _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff, cand)
    k2 = _resolve_max_neighbors(max_neighbors2, neighbor_matrix2, cutoff2, cand)

    nm1, num1, sh1, nm2, num2, sh2 = streaming_pair_search(
        positions,
        cell_b,
        shifts,
        jnp.asarray(cutoff, dtype=positions.dtype) ** 2,
        k1,
        cutoff_sq2=jnp.asarray(cutoff2, dtype=positions.dtype) ** 2,
        max_neighbors2=k2,
        batch_idx=batch_idx,
        half_fill=half_fill,
        fill_value=int(fill_value),
        batched=True,
    )

    if return_neighbor_list:
        out1 = get_neighbor_list_from_neighbor_matrix(
            nm1, num1, sh1 if periodic else None, fill_value=int(fill_value)
        )
        out2 = get_neighbor_list_from_neighbor_matrix(
            nm2, num2, sh2 if periodic else None, fill_value=int(fill_value)
        )
        return out1 + out2
    if periodic:
        return nm1, num1, sh1, nm2, num2, sh2
    return nm1, num1, nm2, num2
