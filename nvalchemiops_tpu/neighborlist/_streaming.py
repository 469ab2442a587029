# SPDX-License-Identifier: Apache-2.0
"""Streaming O(N^2) pair-search core shared by all naive neighbor-list variants.

Replaces the reference's atomic-insert Warp kernels (naive.py:36-182,
batch_naive.py:37-210, *_dual_cutoff.py) with a single scatter-free engine:

- the candidate space is the Cartesian product ``shifts x atoms`` enumerated
  column-major (priority = shift_idx * N + j),
- candidates are processed in fixed-size column chunks under ``lax.scan``,
- per chunk, squared distances are three fused [N, C] broadcasts (C is
  the wide trailing axis),
- hits are merged into a running per-row top-k of priority keys
  (see neighbor_utils.pack_block / merge_topk), giving deterministic,
  (shift, j)-sorted rows.

A dual-cutoff pass shares the distance computation between both cutoffs,
mirroring the reference's fused dual kernels (naive_dual_cutoff.py:36-282).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist.neighbor_utils import (
    decode_keys,
    merge_topk,
    pack_block,
)


def _choose_chunk(total_cols: int, max_neighbors: int) -> int:
    """Static column-chunk size: a multiple of 128, >= 2*K, bounded for memory."""
    target = max(512, 2 * max_neighbors)
    target = min(total_cols, max(target, 2048))
    return ((target + 127) // 128) * 128


@partial(
    jax.jit,
    static_argnames=(
        "max_neighbors",
        "max_neighbors2",
        "half_fill",
        "fill_value",
        "batched",
    ),
)
def streaming_pair_search(
    positions,
    cell,
    shifts_int,
    cutoff_sq,
    max_neighbors: int,
    *,
    cutoff_sq2=None,
    max_neighbors2: int | None = None,
    batch_idx=None,
    half_fill: bool = False,
    fill_value: int = -1,
    batched: bool = False,
):
    """Run the streaming pair search.

    Parameters
    ----------
    positions : [N, 3] float
    cell : [B, 3, 3] float — identity is fine for the non-periodic path
        (``shifts_int`` is then just the zero shift).
    shifts_int : [S, 3] int32 — static S; full-space list for ``half_fill=False``,
        half-space list for ``half_fill=True``.
    cutoff_sq : scalar — squared cutoff.
    max_neighbors : int (static)
    cutoff_sq2 / max_neighbors2 : optional second cutoff (dual-cutoff mode).
    batch_idx : [N] int32 — required when ``batched`` (pairs must share a system;
        the shift Cartesianization uses each pair's own cell).
    half_fill : bool (static) — store each pair once: for the zero shift only
        ``j > i`` rows are kept (reference semantics, naive.py:64-66 with
        neighbor_utils.py:70-147).
    fill_value : int (static) — padding value for the neighbor matrix.

    Returns
    -------
    (neighbor_matrix [N, K] int32, num_neighbors [N] int32,
     shift_matrix [N, K, 3] int32)
    and, in dual mode, a second triple for cutoff2.
    """
    n = positions.shape[0]
    s = shifts_int.shape[0]
    dtype = positions.dtype
    dual = cutoff_sq2 is not None

    cutoff_sq = jnp.asarray(cutoff_sq, dtype=dtype)
    if dual:
        cutoff_sq2 = jnp.asarray(cutoff_sq2, dtype=dtype)

    total_cols = s * n
    k1 = max_neighbors
    k2 = max_neighbors2 if dual else 0

    if n == 0 or total_cols == 0:
        empty = (
            jnp.full((n, k1), fill_value, dtype=INDEX_DTYPE),
            jnp.zeros((n,), dtype=INDEX_DTYPE),
            jnp.zeros((n, k1, 3), dtype=INDEX_DTYPE),
        )
        if dual:
            return empty + (
                jnp.full((n, k2), fill_value, dtype=INDEX_DTYPE),
                jnp.zeros((n,), dtype=INDEX_DTYPE),
                jnp.zeros((n, k2, 3), dtype=INDEX_DTYPE),
            )
        return empty

    # Cartesian shifts per (shift, system): [S, B, 3]
    shift_cart = jnp.einsum(
        "sd,bde->sbe", shifts_int.astype(dtype), jnp.asarray(cell, dtype=dtype)
    )
    is_zero_shift_s = jnp.all(shifts_int == 0, axis=1)  # [S]

    if batched:
        sys_i = batch_idx.astype(INDEX_DTYPE)
    else:
        sys_i = None

    px = positions[:, 0]
    py = positions[:, 1]
    pz = positions[:, 2]
    row_ids = jax.lax.broadcasted_iota(INDEX_DTYPE, (n, 1), 0)

    chunk = _choose_chunk(total_cols, max(k1, k2))
    num_chunks = -(-total_cols // chunk)

    def compute_block(start):
        cols = start + jax.lax.broadcasted_iota(INDEX_DTYPE, (chunk, 1), 0)[:, 0]
        valid_col = cols < total_cols
        cols_c = jnp.minimum(cols, total_cols - 1)
        s_idx = cols_c // n
        j = cols_c - s_idx * n
        is_zero = is_zero_shift_s[s_idx]  # [C]

        if batched:
            sys_j = sys_i[j]  # [C]
            sc = shift_cart[s_idx, sys_j]  # [C, 3]
        else:
            sc = shift_cart[s_idx, 0]  # [C, 3]

        # image of atom j for this column
        qx = px[j] + sc[:, 0]
        qy = py[j] + sc[:, 1]
        qz = pz[j] + sc[:, 2]

        dx = qx[None, :] - px[:, None]
        dy = qy[None, :] - py[:, None]
        dz = qz[None, :] - pz[:, None]
        d2 = dx * dx + dy * dy + dz * dz  # [N, C]

        j_row = j[None, :]
        self_pair = is_zero[None, :] & (j_row == row_ids)
        mask = (d2 < cutoff_sq) & valid_col[None, :] & ~self_pair
        if half_fill:
            mask &= ~(is_zero[None, :] & (j_row <= row_ids))
        if batched:
            mask &= sys_i[j][None, :] == sys_i[:, None]
        if dual:
            mask2 = (d2 < cutoff_sq2) & valid_col[None, :] & ~self_pair
            if half_fill:
                mask2 &= ~(is_zero[None, :] & (j_row <= row_ids))
            if batched:
                mask2 &= sys_i[j][None, :] == sys_i[:, None]
        else:
            mask2 = None
        return cols, mask, mask2

    def scan_body(carry, start):
        keys1, counts1, keys2, counts2 = carry
        cols, mask, mask2 = compute_block(start)
        block_keys = pack_block(mask, cols[None, :], total_cols)
        keys1 = merge_topk(keys1, block_keys, k1)
        counts1 = counts1 + jnp.sum(mask, axis=1, dtype=INDEX_DTYPE)
        if dual:
            block_keys2 = pack_block(mask2, cols[None, :], total_cols)
            keys2 = merge_topk(keys2, block_keys2, k2)
            counts2 = counts2 + jnp.sum(mask2, axis=1, dtype=INDEX_DTYPE)
        return (keys1, counts1, keys2, counts2), None

    init = (
        jnp.zeros((n, k1), dtype=INDEX_DTYPE),
        jnp.zeros((n,), dtype=INDEX_DTYPE),
        jnp.zeros((n, max(k2, 1)), dtype=INDEX_DTYPE),
        jnp.zeros((n,), dtype=INDEX_DTYPE),
    )
    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * chunk
    (keys1, counts1, keys2, counts2), _ = jax.lax.scan(scan_body, init, starts)

    def decode(keys, count):
        valid, pri = decode_keys(keys, total_cols)
        s_idx = pri // n
        j = pri - s_idx * n
        nm = jnp.where(valid, j, jnp.asarray(fill_value, dtype=INDEX_DTYPE))
        sh = jnp.where(valid[..., None], shifts_int[s_idx], 0).astype(INDEX_DTYPE)
        return nm, count, sh

    out1 = decode(keys1, counts1)
    if dual:
        return out1 + decode(keys2[:, :k2], counts2)
    return out1
