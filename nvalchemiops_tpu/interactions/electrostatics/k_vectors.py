# SPDX-License-Identifier: Apache-2.0
"""Reciprocal-space k-vector generation.

JAX counterpart of
``nvalchemiops/interactions/electrostatics/k_vectors.py:19-298``.  Both
generators keep the reference conventions:

- reciprocal matrix ``2 pi (cell^T)^-1`` (lattice vectors are cell rows),
- Ewald summation: half-space Miller enumeration (h>0, or h=0 & k>0, or
  h=k=0 & l>0), k=0 excluded, paired with the 8-pi Green's function,
- PME: rfft-grid Miller indices (z-dimension halved), with a
  division-safe |k|^2.

The Miller-index *ranges* are data-dependent sizes and are resolved on the
host (the reference equally materializes them eagerly in torch); the k-vector
*values* are computed in jnp, so gradients with respect to ``cell`` flow.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

TWOPI = 2.0 * math.pi

__all__ = ["generate_k_vectors_ewald_summation", "generate_k_vectors_pme"]


def _miller_ranges(cell, k_cutoff) -> np.ndarray:
    """Max Miller index per dimension: ceil(k_cutoff * |a_d| / 2 pi), batch max."""
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(-1, 3, 3)
    lengths = np.linalg.norm(cell_np, axis=-1).max(axis=0) / TWOPI
    kc = float(np.max(np.asarray(jax.device_get(k_cutoff))))
    return np.ceil(kc * lengths).astype(np.int64)


def halfspace_miller_indices(max_hkl: np.ndarray) -> np.ndarray:
    """All half-space Miller triples within the given ranges (k=0 excluded)."""
    h = np.arange(-max_hkl[0], max_hkl[0] + 1)
    k = np.arange(-max_hkl[1], max_hkl[1] + 1)
    m = np.arange(-max_hkl[2], max_hkl[2] + 1)
    hh, kk, mm = np.meshgrid(h, k, m, indexing="ij")
    grid = np.stack([hh.ravel(), kk.ravel(), mm.ravel()], axis=1)
    hs = (
        (grid[:, 0] > 0)
        | ((grid[:, 0] == 0) & (grid[:, 1] > 0))
        | ((grid[:, 0] == 0) & (grid[:, 1] == 0) & (grid[:, 2] > 0))
    )
    return grid[hs]


def generate_k_vectors_ewald_summation(cell, k_cutoff, max_hkl=None):
    """Half-space k-vectors for classical Ewald summation.

    Returns shape (K, 3) for a single system or (B, K, 3) for a batch; the
    same Miller set is transformed by each system's reciprocal cell
    (reference: k_vectors.py:43-164).

    The Miller *ranges* are resolved from concrete cell values on the host;
    under a trace (e.g. ``jax.grad`` with respect to ``cell``) pass
    ``max_hkl`` (int triple, e.g. from :func:`_miller_ranges` at the
    unperturbed cell) so the k-vector *values* stay traced while the static
    enumeration is fixed.
    """
    cell_arr = jnp.asarray(cell)
    squeeze = cell_arr.ndim == 2
    cell_b = cell_arr.reshape(-1, 3, 3)
    if max_hkl is None:
        if isinstance(cell_arr, jax.core.Tracer):
            raise ValueError(
                "generate_k_vectors_ewald_summation under a jax trace needs "
                "an explicit max_hkl (the Miller ranges are host-resolved "
                "from concrete cell values)"
            )
        max_hkl = _miller_ranges(cell_b, k_cutoff)
    millers = jnp.asarray(
        halfspace_miller_indices(np.asarray(max_hkl)),
        dtype=cell_b.dtype,
    )
    reciprocal = TWOPI * jnp.linalg.inv(jnp.swapaxes(cell_b, -1, -2))
    # exact f32 elementwise (no reduced-precision K=3 einsum; see
    # mathops.apply_mat3)
    k_vectors = sum(
        millers[None, :, d:d + 1] * reciprocal[:, None, d] for d in range(3)
    )
    return k_vectors[0] if squeeze else k_vectors


def generate_k_vectors_pme(cell, mesh_dimensions, reciprocal_cell=None):
    """rfft-grid k-vectors for PME (reference: k_vectors.py:167-298).

    Returns ``(k_vectors [nx, ny, nz//2+1, 3], k_squared_safe)`` (leading
    batch axis when ``cell`` is batched).  Miller indices follow the
    fftfreq/rfftfreq conventions so the arrays align with ``jnp.fft.rfftn``
    output.
    """
    cell_arr = jnp.asarray(cell)
    squeeze = cell_arr.ndim == 2
    cell_b = cell_arr.reshape(-1, 3, 3)
    dtype = cell_b.dtype
    nx, ny, nz = mesh_dimensions

    if reciprocal_cell is None:
        reciprocal_cell = TWOPI * jnp.linalg.inv(jnp.swapaxes(cell_b, -1, -2))
    else:
        reciprocal_cell = jnp.asarray(reciprocal_cell, dtype=dtype).reshape(-1, 3, 3)

    mx = jnp.fft.fftfreq(nx, d=1.0).astype(dtype) * nx
    my = jnp.fft.fftfreq(ny, d=1.0).astype(dtype) * ny
    mz = jnp.fft.rfftfreq(nz, d=1.0).astype(dtype) * nz
    gx, gy, gz = jnp.meshgrid(mx, my, mz, indexing="ij")
    miller_grid = jnp.stack([gx, gy, gz], axis=-1)  # [nx, ny, nz//2+1, 3]

    # exact f32 elementwise (no reduced-precision K=3 einsum; see
    # mathops.apply_mat3)
    k_vectors = sum(
        miller_grid[None, ..., d:d + 1]
        * reciprocal_cell[:, None, None, None, d]
        for d in range(3)
    )
    k_squared = jnp.sum(k_vectors**2, axis=-1)
    k_squared_safe = jnp.where(k_squared > 1e-12, k_squared, 1e-12)
    if squeeze:
        return k_vectors[0], k_squared_safe[0]
    return k_vectors, k_squared_safe
