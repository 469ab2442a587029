# SPDX-License-Identifier: Apache-2.0
"""Batch-sharded PME: the uniform [B, n] batch pipeline over a device mesh.

The reference is single-GPU (SURVEY.md §2.8 — no distribution anywhere);
this is an extension.  Per-system PME is embarrassingly
parallel across the batch axis, so the sharding is a pure
``shard_map`` over system shards — each device runs the tile-windowed
batch pipeline (:func:`~nvalchemiops_tpu.interactions.electrostatics.
pme.batch_pme_reciprocal`) on its local systems and no collectives are
needed; outputs come back sharded the same way.  Complements the z-slab
*domain* PME (parallel/domain.py:domain_pme_reciprocal), which shards one
large system instead.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["sharded_batch_pme_reciprocal"]


def sharded_batch_pme_reciprocal(mesh: Mesh, positions, charges, cells,
                                 alpha, mesh_dimensions,
                                 spline_order: int = 4,
                                 compute_forces: bool = False,
                                 axis: str = "dp", **kw):
    """Shard ``batch_pme_reciprocal`` over ``mesh`` axis ``axis``.

    ``positions`` [B, n, 3], ``charges`` [B, n]; ``cells`` [3, 3] shared
    or [B, 3, 3]; ``alpha`` scalar or [B].  B must divide evenly over the
    mesh axis.  Returns per-atom energies [B, n] (and forces [B, n, 3]
    with ``compute_forces``), sharded over the batch axis.
    """
    from nvalchemiops_tpu.interactions.electrostatics.pme import (
        batch_pme_reciprocal,
    )

    b = positions.shape[0]
    n_shards = mesh.shape[axis]
    if b % n_shards:
        raise ValueError(
            f"batch size {b} does not divide over mesh axis "
            f"{axis!r} ({n_shards} shards)")
    dtype = positions.dtype
    cells = jnp.asarray(cells, dtype)
    if cells.ndim == 2:
        cells = jnp.broadcast_to(cells[None], (b, 3, 3))
    alphas = jnp.broadcast_to(jnp.asarray(alpha, dtype).reshape(-1), (b,))
    # tile capacity must be identical on every shard (static shape): the
    # default derives from the per-system atom count, already shard-safe
    mesh_dimensions = tuple(int(d) for d in mesh_dimensions)

    def local(p, q, c, a):
        out = batch_pme_reciprocal(
            p, q, c, a, mesh_dimensions, spline_order=spline_order,
            compute_forces=compute_forces, **kw)
        return out if compute_forces else (out,)

    spec = P(axis)
    out_specs = (spec, spec) if compute_forces else (spec,)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=out_specs,
        check_vma=False,
    )
    out = fn(positions, charges, cells, alphas)
    return out if compute_forces else out[0]
