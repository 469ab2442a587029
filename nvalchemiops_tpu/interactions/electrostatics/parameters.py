# SPDX-License-Identifier: Apache-2.0
"""Ewald / PME parameter estimation.

JAX counterpart of
``nvalchemiops/interactions/electrostatics/parameters.py:67-437``.
Kolafa-Perram balancing for Ewald and B-spline error analysis for the PME
mesh.  The dataclass containers mirror the reference; mesh dimensions are
Python ints (static shapes for XLA), everything else stays in jnp so the
estimates can be differentiated or jitted when the cell is traced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "EwaldParameters",
    "PMEParameters",
    "estimate_ewald_parameters",
    "estimate_pme_mesh_dimensions",
    "estimate_pme_parameters",
    "mesh_spacing_to_dimensions",
]


@dataclass
class EwaldParameters:
    """Ewald splitting parameters (reference: parameters.py:67-91)."""

    alpha: jax.Array
    real_space_cutoff: jax.Array
    reciprocal_space_cutoff: jax.Array


@dataclass
class PMEParameters:
    """PME parameters incl. mesh sizing (reference: parameters.py:94-124)."""

    alpha: jax.Array
    mesh_dimensions: tuple[int, int, int]
    mesh_spacing: jax.Array
    real_space_cutoff: jax.Array


def _atoms_per_system(positions, num_systems: int, batch_idx):
    if batch_idx is None:
        return jnp.full((num_systems,), positions.shape[0], dtype=positions.dtype)
    ones = jnp.ones(positions.shape[0], dtype=positions.dtype)
    return jax.ops.segment_sum(ones, batch_idx.astype(jnp.int32), num_segments=num_systems)


def estimate_ewald_parameters(positions, cell, batch_idx=None, accuracy: float = 1e-6):
    """Kolafa-Perram estimate (reference: parameters.py:156-242).

    eta = (V^2/N)^(1/6) / sqrt(2 pi);  alpha = 1/(sqrt(2) eta);
    r_cut = sqrt(-2 ln eps) * eta;     k_cut = sqrt(-2 ln eps) / eta.
    """
    cell_b = jnp.asarray(cell).reshape(-1, 3, 3)
    num_systems = cell_b.shape[0]
    volume = jnp.abs(jnp.linalg.det(cell_b))
    num_atoms = _atoms_per_system(positions, num_systems, batch_idx)
    eta = (volume**2 / num_atoms) ** (1.0 / 6.0) / math.sqrt(2.0 * math.pi)
    error_factor = math.sqrt(-2.0 * math.log(accuracy))
    return EwaldParameters(
        alpha=1.0 / (math.sqrt(2.0) * eta),
        real_space_cutoff=error_factor * eta,
        reciprocal_space_cutoff=error_factor / eta,
    )


def _round_up_pow2(n: np.ndarray) -> np.ndarray:
    return np.power(2, np.ceil(np.log2(np.maximum(n, 1)))).astype(np.int64)


def estimate_pme_mesh_dimensions(cell, alpha, accuracy: float = 1e-6):
    """Mesh dims ``n = ceil(2 alpha L / (3 eps^(1/5)))`` rounded to powers of 2.

    (reference: parameters.py:245-307.)  Host-side: mesh dimensions are
    static FFT shapes.
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(-1, 3, 3)
    alpha_np = np.asarray(jax.device_get(alpha), dtype=np.float64).reshape(-1)
    lengths = np.linalg.norm(cell_np, axis=2)  # [B, 3]
    n = 2.0 * alpha_np[:, None] * lengths / (3.0 * accuracy**0.2)
    dims = _round_up_pow2(np.ceil(n.max(axis=0)))
    return int(dims[0]), int(dims[1]), int(dims[2])


def estimate_pme_parameters(positions, cell, batch_idx=None, accuracy: float = 1e-6):
    """Ewald estimate + PME mesh sizing (reference: parameters.py:310-376)."""
    cell_b = jnp.asarray(cell).reshape(-1, 3, 3)
    ewald = estimate_ewald_parameters(positions, cell_b, batch_idx, accuracy)
    mesh_dims = estimate_pme_mesh_dimensions(cell_b, ewald.alpha, accuracy)
    lengths = jnp.linalg.norm(cell_b, axis=2)
    mesh_spacing = lengths / jnp.asarray(mesh_dims, dtype=lengths.dtype)
    return PMEParameters(
        alpha=ewald.alpha,
        mesh_dimensions=mesh_dims,
        mesh_spacing=mesh_spacing,
        real_space_cutoff=ewald.real_space_cutoff,
    )


def mesh_spacing_to_dimensions(cell, mesh_spacing):
    """Convert a target mesh spacing to power-of-2 mesh dimensions.

    (reference: parameters.py:379-437.)
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(-1, 3, 3)
    lengths = np.linalg.norm(cell_np, axis=2)  # [B, 3]
    spacing = np.asarray(jax.device_get(mesh_spacing), dtype=np.float64)
    if spacing.ndim == 0:
        dims = np.ceil(lengths / spacing)
    elif spacing.ndim == 1:
        if spacing.shape[0] != cell_np.shape[0]:
            raise ValueError(
                f"mesh_spacing shape {spacing.shape} incompatible with batch "
                f"size {cell_np.shape[0]}"
            )
        dims = np.ceil(lengths / spacing[:, None])
    else:
        if spacing.shape != lengths.shape:
            raise ValueError(
                f"mesh_spacing shape {spacing.shape} incompatible with "
                f"cell_lengths shape {lengths.shape}"
            )
        dims = np.ceil(lengths / spacing)
    dims = _round_up_pow2(dims).max(axis=0)
    return int(dims[0]), int(dims[1]), int(dims[2])
