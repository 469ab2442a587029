# SPDX-License-Identifier: Apache-2.0
"""Dense minimum-image (damped) Coulomb: the small-system batched fast path.

Counterpart of dense_d3.py for electrostatics: full [n, n] pair planes
(structure-of-arrays displacements, zero capacity slack), valid for
cutoff <= box/2; vmappable over a batch axis.  This is the real-space
engine that pairs with the batched PME/Ewald reciprocal paths for the
reference's 64x2000-style batched workloads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.mathops.math import apply_mat3, erfc_approx

__all__ = ["dense_coulomb_energy_forces", "batch_dense_coulomb_energy_forces"]

_TWO_OVER_SQRT_PI = 1.1283791670955126


def dense_coulomb_energy_forces(positions, charges, cell, cutoff, alpha=0.0):
    """Per-atom (damped-)Coulomb energies and forces, minimum-image O(n^2).

    Same physics contract as
    :func:`nvalchemiops_tpu.grid.grid_coulomb_energy_forces`; requires
    cutoff <= half the smallest box dimension.
    """
    dtype = positions.dtype
    cell = jnp.asarray(cell, dtype).reshape(3, 3)
    charges = jnp.asarray(charges, dtype)
    cutoff_t = jnp.asarray(cutoff, dtype)
    alpha_t = jnp.asarray(alpha, dtype)

    inv_cell = jnp.linalg.inv(cell)
    frac = apply_mat3(positions, inv_cell)  # exact f32 (no matmul)
    df = []
    for c in range(3):
        fc = frac[:, c]
        dc = fc[None, :] - fc[:, None]
        df.append(dc - jnp.round(dc))
    dx = df[0] * cell[0, 0] + df[1] * cell[1, 0] + df[2] * cell[2, 0]
    dy = df[0] * cell[0, 1] + df[1] * cell[1, 1] + df[2] * cell[2, 1]
    dz = df[0] * cell[0, 2] + df[1] * cell[1, 2] + df[2] * cell[2, 2]
    r2 = dx * dx + dy * dy + dz * dz
    ok = (r2 < cutoff_t * cutoff_t) & (r2 > 1e-20)
    r2_safe = jnp.where(ok, r2, 1.0)
    inv_r = jax.lax.rsqrt(r2_safe)

    qq = charges[:, None] * charges[None, :]
    damped = alpha_t > 0
    r = r2_safe * inv_r
    ar = alpha_t * r
    erfc_ar = erfc_approx(ar)
    phi = jnp.where(damped, erfc_ar * inv_r, inv_r)
    mag = jnp.where(
        damped,
        (erfc_ar * inv_r + _TWO_OVER_SQRT_PI * alpha_t * jnp.exp(-ar * ar))
        * inv_r * inv_r,
        inv_r * inv_r * inv_r,
    )
    e_pair = jnp.where(ok, 0.5 * qq * phi, 0.0)
    # force on i = -sum_j coef * d_ij with d = r_j - r_i (matches the grid
    # engine's sign convention)
    ncoef = jnp.where(ok, -(qq * mag), 0.0)
    energies = jnp.sum(e_pair, axis=1)
    forces = jnp.stack(
        [jnp.sum(ncoef * dx, axis=1), jnp.sum(ncoef * dy, axis=1),
         jnp.sum(ncoef * dz, axis=1)],
        axis=-1,
    )
    return energies, forces


def batch_dense_coulomb_energy_forces(positions, charges, cells, cutoff,
                                      alpha=0.0):
    """vmap of :func:`dense_coulomb_energy_forces` over the system axis.

    ``positions`` [B, n, 3], ``charges`` [B, n], ``cells`` [3, 3] shared
    or [B, 3, 3].
    """
    cells = jnp.asarray(cells, positions.dtype)
    if cells.ndim == 2:
        return jax.vmap(
            lambda p, q: dense_coulomb_energy_forces(p, q, cells, cutoff,
                                                     alpha)
        )(positions, charges)
    return jax.vmap(
        lambda p, q, c: dense_coulomb_energy_forces(p, q, c, cutoff, alpha)
    )(positions, charges, cells)
