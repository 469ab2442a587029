# SPDX-License-Identifier: Apache-2.0
"""Dual-cutoff brute-force neighbor lists (single system).

JAX counterpart of ``nvalchemiops/neighborlist/naive_dual_cutoff.py``
(kernels at naive_dual_cutoff.py:36-282, wrapper at :544-919): one distance
pass fills two neighbor matrices for two cutoff radii — the common MLIP
short-radius / long-radius pattern.  The streaming engine computes distances
once and maintains two top-k carries.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist._streaming import streaming_pair_search
from nvalchemiops_tpu.neighborlist.naive import _resolve_max_neighbors, _shift_table
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    get_neighbor_list_from_neighbor_matrix,
)

__all__ = ["naive_neighbor_list_dual_cutoff"]


def naive_neighbor_list_dual_cutoff(
    positions,
    cutoff: float,
    cutoff2: float,
    pbc=None,
    cell=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    max_neighbors2: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix2=None,
    **_ignored,
):
    """Single-pass dual-cutoff neighbor matrices.

    Returns, matching the reference's interleaved pattern
    (neighborlist.py:152-160):

    - no PBC: ``(nm1, num1, nm2, num2)``
    - PBC: ``(nm1, num1, shifts1, nm2, num2, shifts2)``

    and their COO/CSR conversions for ``return_neighbor_list=True``.
    """
    positions = jnp.asarray(positions)
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    periodic = pbc is not None and cell is not None and bool(np.asarray(pbc).any())

    shift_cutoff = max(float(cutoff), float(cutoff2))
    if periodic:
        cell_b = jnp.asarray(cell).reshape(1, 3, 3)
        shifts = jnp.asarray(_shift_table(cell_b, shift_cutoff, pbc, half_fill))
    else:
        cell_b = jnp.eye(3, dtype=positions.dtype).reshape(1, 3, 3)
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
        half_fill=half_fill,
        fill_value=int(fill_value),
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
