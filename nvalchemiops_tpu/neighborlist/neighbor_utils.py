# SPDX-License-Identifier: Apache-2.0
"""Shared neighbor-list utilities and the top-k packing primitive.

JAX counterpart of ``nvalchemiops/neighborlist/neighbor_utils.py``.
The reference fills padded neighbor matrices with ``wp.atomic_add`` row
counters (neighbor_utils.py:70-147).  This module replaces that pattern with a deterministic, scatter-free
compaction primitive built on ``jax.lax.top_k``:

- every candidate pair gets an integer *priority* (its position in a fixed
  enumeration of the candidate space),
- valid candidates are encoded as ``NUM_CANDIDATES - priority`` (> 0),
  invalid ones as 0,
- a running top-k merge keeps the ``max_neighbors`` best keys per row while
  scanning candidate blocks, so memory stays O(N * (K + block)).

Rows come out sorted by priority (deterministic), counts are exact even on
overflow — matching the reference contract where ``num_neighbors`` may exceed
``max_neighbors`` and overflow is detected after the fact
(neighbor_utils.py:343-359).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nvalchemiops_tpu.types import INDEX_DTYPE

__all__ = [
    "NeighborOverflowError",
    "assert_max_neighbors",
    "estimate_max_neighbors",
    "compute_naive_num_shifts",
    "expand_naive_shifts",
    "expand_full_shifts",
    "get_neighbor_list_from_neighbor_matrix",
    "prepare_batch_idx_ptr",
    "pack_block",
    "merge_topk",
    "decode_keys",
    "pack_shifts",
    "unpack_shifts",
    "shifts_to_aos",
    "shifts_from_aos",
]


# ---------------------------------------------------------------------------
# Packing primitive
# ---------------------------------------------------------------------------


def pack_block(mask, priorities, num_candidates):
    """Encode a candidate block as sortable keys.

    Parameters
    ----------
    mask : bool [R, C]
        Valid candidates.
    priorities : int32 [C] or [R, C]
        Global candidate priorities (0 = highest / packed first).
    num_candidates : int
        Static total size of the candidate space (max priority + 1).

    Returns
    -------
    keys : int32 [R, C] — ``num_candidates - priority`` where valid, else 0.
    """
    pri = jnp.asarray(priorities, dtype=INDEX_DTYPE)
    keys = jnp.asarray(num_candidates, dtype=INDEX_DTYPE) - pri
    return jnp.where(mask, keys, jnp.zeros((), dtype=INDEX_DTYPE))


def merge_topk(carry_keys, block_keys, k):
    """Merge a block of keys into the running per-row top-k."""
    both = jnp.concatenate([carry_keys, block_keys], axis=-1)
    merged, _ = jax.lax.top_k(both, k)
    return merged


def decode_keys(keys, num_candidates):
    """Invert :func:`pack_block`: returns (valid [R,K] bool, priority [R,K])."""
    valid = keys > 0
    pri = jnp.asarray(num_candidates, dtype=INDEX_DTYPE) - keys
    return valid, jnp.where(valid, pri, jnp.zeros((), dtype=INDEX_DTYPE))


# ---------------------------------------------------------------------------
# Size estimation / overflow (reference: neighbor_utils.py:296-359)
# ---------------------------------------------------------------------------


def estimate_max_neighbors(
    cutoff: float,
    atomic_density: float = 0.35,
    safety_factor: float = 5.0,
) -> int:
    """Density-heuristic upper bound on neighbors per atom, rounded up to 16.

    Mirrors the reference heuristic (neighbor_utils.py:296-340):
    ``safety_factor * density * (4/3) pi cutoff^3`` rounded up to a multiple
    of 16; 0 for non-positive cutoffs.
    """
    if cutoff <= 0:
        return 0
    cutoff_sphere_volume = atomic_density * (4.0 / 3.0) * math.pi * (cutoff**3)
    expected = max(1.0, safety_factor * cutoff_sphere_volume)
    return int(math.ceil(expected / 16)) * 16


class NeighborOverflowError(Exception):
    """Raised when an atom has more neighbors than the matrix capacity."""

    def __init__(self, max_neighbors: int, num_neighbors: int):
        super().__init__(
            "The number of neighbors is larger than the maximum allowed: "
            f"{num_neighbors} > {max_neighbors}."
        )


def assert_max_neighbors(neighbor_matrix, num_neighbors) -> None:
    """Raise :class:`NeighborOverflowError` on capacity overflow (host sync)."""
    if num_neighbors.size == 0:
        return
    observed = int(jax.device_get(jnp.max(num_neighbors)))
    if observed > neighbor_matrix.shape[1]:
        raise NeighborOverflowError(neighbor_matrix.shape[1], observed)


# ---------------------------------------------------------------------------
# Periodic shift enumeration (reference: neighbor_utils.py:150-293)
# ---------------------------------------------------------------------------


def _shift_range_for_cell(cell: np.ndarray, cutoff: float, pbc: np.ndarray) -> np.ndarray:
    """Per-dimension shift range ``ceil(|column_d of cell^-1| * cutoff)``."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell).T  # rows of (cell^-1)^T = columns of cell^-1
    d_inv = np.linalg.norm(inv_t, axis=1)
    d_inv = np.where(np.asarray(pbc, dtype=bool), d_inv, 0.0)
    return np.ceil(d_inv * float(cutoff)).astype(np.int64)


def compute_naive_num_shifts(cell, cutoff: float, pbc):
    """Host-side shift-count computation (requires concrete ``cell``).

    Equivalent to the reference's device kernel + ``.item()`` sync
    (neighbor_utils.py:150-293): this is the one place where a data-dependent
    size escapes to the host, isolated exactly like the reference isolates it.

    Parameters
    ----------
    cell : array [num_systems, 3, 3] (or [3, 3])
    cutoff : float
    pbc : bool array [num_systems, 3] (or [3])

    Returns
    -------
    shift_range : np.ndarray [num_systems, 3] int
    shift_offset : np.ndarray [num_systems + 1] int — cumulative half-space counts
    total_shifts : int
    """
    cell = np.asarray(jax.device_get(cell), dtype=np.float64)
    if cell.ndim == 2:
        cell = cell[None]
    pbc = np.asarray(jax.device_get(pbc), dtype=bool)
    if pbc.ndim == 1:
        pbc = pbc[None]
    if pbc.shape[0] == 1 and cell.shape[0] > 1:
        pbc = np.broadcast_to(pbc, (cell.shape[0], 3))

    num_systems = cell.shape[0]
    shift_range = np.zeros((num_systems, 3), dtype=np.int64)
    counts = np.zeros(num_systems, dtype=np.int64)
    for b in range(num_systems):
        s = _shift_range_for_cell(cell[b], cutoff, pbc[b])
        shift_range[b] = s
        k1, k2 = 2 * s[1] + 1, 2 * s[2] + 1
        counts[b] = s[0] * k1 * k2 + s[1] * k2 + s[2] + 1
    shift_offset = np.concatenate([[0], np.cumsum(counts)])
    return shift_range, shift_offset, int(shift_offset[-1])


def expand_naive_shifts(shift_range: np.ndarray) -> np.ndarray:
    """Half-space shift vectors for one system (includes the zero shift).

    Enumeration order and half-space condition follow the reference
    (neighbor_utils.py:26-67): ``k0 > 0 or (k0 == 0 and k1 > 0) or
    (k0 == 0 and k1 == 0 and k2 >= 0)`` with k0 in [0, s0],
    k1/k2 in [-s, s].
    """
    s0, s1, s2 = (int(v) for v in np.asarray(shift_range).reshape(3))
    out = []
    for k0 in range(0, s0 + 1):
        for k1 in range(-s1, s1 + 1):
            for k2 in range(-s2, s2 + 1):
                if k0 > 0 or (k0 == 0 and k1 > 0) or (k0 == 0 and k1 == 0 and k2 >= 0):
                    out.append((k0, k1, k2))
    return np.asarray(out, dtype=np.int32).reshape(-1, 3)


def expand_full_shifts(shift_range: np.ndarray) -> np.ndarray:
    """Full-space shift vectors (both signs), zero shift first.

    The full space is what a row-owner enumeration needs: row ``a`` holds
    ``(b, S)`` for every image ``r_b + S @ cell`` within the cutoff, which is
    exactly what the reference's symmetric atomic insertion produces from the
    half-space sweep.
    """
    s0, s1, s2 = (int(v) for v in np.asarray(shift_range).reshape(3))
    grid = np.stack(
        np.meshgrid(
            np.arange(-s0, s0 + 1),
            np.arange(-s1, s1 + 1),
            np.arange(-s2, s2 + 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)
    # order: zero shift first, then by lexicographic distance for determinism
    order = np.lexsort((grid[:, 2], grid[:, 1], grid[:, 0], (grid != 0).any(axis=1)))
    return grid[order].astype(np.int32)


# ---------------------------------------------------------------------------
# Format conversion (reference: neighbor_utils.py:362-441)
# ---------------------------------------------------------------------------


def get_neighbor_list_from_neighbor_matrix(
    neighbor_matrix,
    num_neighbors,
    neighbor_shift_matrix=None,
    fill_value: int = -1,
):
    """Convert a padded neighbor matrix to COO + CSR form.

    This produces data-dependent shapes, so it runs on the host (the
    reference equally recommends staying in matrix format,
    neighborlist.py:82-86).  Returns int32 numpy-backed jnp arrays:
    ``neighbor_list [2, num_pairs]``, ``neighbor_ptr [total_atoms + 1]`` and,
    when shifts are given, ``unit_shifts [num_pairs, 3]``.
    """
    num_neighbors = jax.device_get(num_neighbors)
    if num_neighbors.shape[0] == 0:
        neighbor_list = jnp.zeros((2, 0), dtype=INDEX_DTYPE)
        neighbor_ptr = jnp.zeros((1,), dtype=INDEX_DTYPE)
        if neighbor_shift_matrix is not None:
            return neighbor_list, neighbor_ptr, jnp.zeros((0, 3), dtype=INDEX_DTYPE)
        return neighbor_list, neighbor_ptr

    assert_max_neighbors(neighbor_matrix, num_neighbors)

    nm = np.asarray(jax.device_get(neighbor_matrix))
    mask = nm != fill_value
    i_idx, slot_idx = np.nonzero(mask)
    neighbor_list = jnp.asarray(
        np.stack([i_idx.astype(np.int32), nm[mask].astype(np.int32)], axis=0)
    )
    ptr = np.zeros(num_neighbors.shape[0] + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.asarray(num_neighbors, dtype=np.int32))
    neighbor_ptr = jnp.asarray(ptr)
    if neighbor_shift_matrix is not None:
        shifts = np.asarray(jax.device_get(neighbor_shift_matrix))[mask]
        return neighbor_list, neighbor_ptr, jnp.asarray(shifts.astype(np.int32))
    return neighbor_list, neighbor_ptr


# ---------------------------------------------------------------------------
# Batch bookkeeping (reference: neighbor_utils.py:444-491)
# ---------------------------------------------------------------------------


def prepare_batch_idx_ptr(batch_idx, batch_ptr, num_atoms: int):
    """Derive whichever of ``batch_idx`` / ``batch_ptr`` is missing.

    Host-side (concrete inputs).  Returns int32 jnp arrays.
    """
    if batch_idx is None and batch_ptr is None:
        raise ValueError("Either batch_idx or batch_ptr must be provided.")

    if batch_idx is None:
        ptr = np.asarray(jax.device_get(batch_ptr), dtype=np.int64)
        counts = ptr[1:] - ptr[:-1]
        idx = np.repeat(np.arange(ptr.shape[0] - 1, dtype=np.int32), counts)
        return jnp.asarray(idx), jnp.asarray(ptr.astype(np.int32))

    idx = np.asarray(jax.device_get(batch_idx), dtype=np.int64)
    if batch_ptr is None:
        num_systems = int(idx.max()) + 1 if idx.size else 1
        counts = np.bincount(idx, minlength=num_systems)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return jnp.asarray(idx.astype(np.int32)), jnp.asarray(ptr)
    return (
        jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(np.asarray(jax.device_get(batch_ptr), dtype=np.int32)),
    )


# ---------------------------------------------------------------------------
# Packed shift encoding
# ---------------------------------------------------------------------------
#
# An AoS shift matrix [N, K, 3] int32 carries a thin trailing dim and three
# times the memory of one int32 per pair with the three components
# bit-packed (10 bits each, range ±511, far beyond any physical shift
# range):
#
#     packed = (sx + 512) << 20 | (sy + 512) << 10 | (sz + 512)
#
# All interaction kernels accept either layout; the packed one keeps every
# array 2-D.

SHIFT_PACK_BIAS = 512
SHIFT_PACK_MASK = 1023


def pack_shifts(sx, sy, sz):
    """Pack three int shift components (|s| <= 511) into one int32."""
    sx = sx.astype(INDEX_DTYPE)
    sy = sy.astype(INDEX_DTYPE)
    sz = sz.astype(INDEX_DTYPE)
    return (
        ((sx + SHIFT_PACK_BIAS) << 20)
        | ((sy + SHIFT_PACK_BIAS) << 10)
        | (sz + SHIFT_PACK_BIAS)
    )


def unpack_shifts(packed):
    """Unpack an int32 shift code into (sx, sy, sz) int32 arrays."""
    packed = packed.astype(INDEX_DTYPE)
    sx = ((packed >> 20) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sy = ((packed >> 10) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sz = (packed & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    return sx, sy, sz


def shifts_to_aos(packed):
    """Packed [.., K] -> AoS [.., K, 3] (CPU/API-parity convenience)."""
    sx, sy, sz = unpack_shifts(packed)
    return jnp.stack([sx, sy, sz], axis=-1)


def shifts_from_aos(aos):
    """AoS [.., K, 3] -> packed [.., K]."""
    return pack_shifts(aos[..., 0], aos[..., 1], aos[..., 2])


# ---------------------------------------------------------------------------
# Gather-free bucket ranking
# ---------------------------------------------------------------------------


def bucket_ranks(lin, num_buckets: int):
    """Per-element rank within its bucket, gather-free.

    The textbook formulation (argsort + ``starts[sorted_lin]`` +
    ``lin[order]``) costs two N-element random gathers.  Instead the
    (bucket, index) pair is
    packed into one sort key — one sort, a boundary scan for the ranks, one
    scatter back to the original order.

    Returns ``(rank [N] int32, counts_max scalar)``; callers build slot ids
    as ``lin * cap + rank``.  Requires ``num_buckets * N < 2^31`` for the
    packed key; falls back to the gather formulation otherwise.
    """
    n = lin.shape[0]
    lin = lin.astype(INDEX_DTYPE)
    if n == 0:
        return jnp.zeros((0,), INDEX_DTYPE), jnp.zeros((), INDEX_DTYPE)
    if float(num_buckets) * float(n) < 2**31:
        key = jnp.sort(lin * n + jnp.arange(n, dtype=INDEX_DTYPE))
        sorted_lin = key // n
        order = key - sorted_lin * n
    else:
        # one multi-operand stable sort: carrying iota as a value gives
        # sorted_lin AND order together with ZERO random gathers
        sorted_lin, order = jax.lax.sort(
            (lin, jnp.arange(n, dtype=INDEX_DTYPE)), num_keys=1,
            is_stable=True)
    idx = jnp.arange(n, dtype=INDEX_DTYPE)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_lin[1:] != sorted_lin[:-1]]
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, idx, 0)
    )
    rank_sorted = idx - run_start
    rank = jnp.zeros((n,), INDEX_DTYPE).at[order].set(rank_sorted)
    counts_max = jnp.max(rank_sorted, initial=-1) + 1
    return rank, counts_max
