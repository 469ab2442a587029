# SPDX-License-Identifier: Apache-2.0
"""Brute-force O(N^2) neighbor list, single system.

JAX counterpart of ``nvalchemiops/neighborlist/naive.py`` (kernels at
naive.py:36-182, wrapper at naive.py:400-706).  Same output contract —
padded ``neighbor_matrix`` / ``num_neighbors`` (+ ``neighbor_matrix_shifts``
under PBC) or the COO/CSR conversion — produced by the scatter-free streaming
engine in ``_streaming.py`` instead of atomic inserts.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist._streaming import streaming_pair_search
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    compute_naive_num_shifts,
    estimate_max_neighbors,
    expand_full_shifts,
    expand_naive_shifts,
    get_neighbor_list_from_neighbor_matrix,
)

__all__ = ["naive_neighbor_list"]


def _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff, total_candidates):
    """Capacity K: explicit > buffer capacity > density heuristic.

    ``total_candidates`` (atoms x periodic images) bounds K — a row can never
    hold more entries than the candidate space.
    """
    if max_neighbors is not None:
        return int(max_neighbors)
    if neighbor_matrix is not None:
        return int(neighbor_matrix.shape[1])
    est = estimate_max_neighbors(cutoff)
    if total_candidates > 0:
        est = max(16, min(est, ((total_candidates + 15) // 16) * 16))
    return est


def _shift_table(cell, cutoff, pbc, half_fill):
    """Host-side shift enumeration (static count) for a single system."""
    shift_range, _, _ = compute_naive_num_shifts(cell, cutoff, pbc)
    if half_fill:
        return expand_naive_shifts(shift_range[0])
    return expand_full_shifts(shift_range[0])


def naive_neighbor_list(
    positions,
    cutoff: float,
    pbc=None,
    cell=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    num_neighbors=None,
    shift_range_per_dimension=None,
    shift_offset=None,
    total_shifts=None,
    **_ignored,
):
    """Compute a neighbor matrix with the brute-force O(N^2) algorithm.

    Parameters mirror the reference wrapper (naive.py:400-706); pre-allocated
    output buffers are accepted for API compatibility but only consulted for
    their capacity (JAX is functional — outputs are freshly computed arrays).

    Returns
    -------
    Without PBC: ``(neighbor_matrix, num_neighbors)``;
    with PBC: ``(neighbor_matrix, num_neighbors, neighbor_matrix_shifts)``.
    With ``return_neighbor_list=True`` the COO/CSR conversion of the same data.
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    periodic = (
        pbc is not None
        and cell is not None
        and bool(np.asarray(pbc).any())
    )

    if periodic:
        cell_arr = jnp.asarray(cell)
        cell_b = cell_arr.reshape(1, 3, 3)
        shifts = jnp.asarray(_shift_table(cell_b, cutoff, pbc, half_fill))
    else:
        cell_b = jnp.eye(3, dtype=positions.dtype).reshape(1, 3, 3)
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
        half_fill=half_fill,
        fill_value=int(fill_value),
    )

    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh if periodic else None, fill_value=int(fill_value)
        )
    if periodic:
        return nm, num, sh
    return nm, num
