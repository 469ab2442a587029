# SPDX-License-Identifier: Apache-2.0
"""Direct and erfc-damped Coulomb interactions.

JAX counterpart of
``nvalchemiops/interactions/electrostatics/coulomb.py`` (8 Warp kernels at
coulomb.py:133-714, wrappers at :1336-1691).  ``alpha = 0`` gives the bare
1/r law; ``alpha > 0`` the erfc-damped form used as the Ewald/PME real-space
term.  Per-atom energies are returned (sum for the total).

Differences from the reference, by design:

- The reference force-upcasts everything to float64 on CUDA
  (coulomb.py:1423-1426).  Kernels here run in the input dtype; pass
  float64 arrays (with x64 enabled) to get the reference's precision
  behavior.
- Both neighbor formats map onto the same vectorized core: the padded matrix
  via [N, K] gathers, the COO list via per-pair arithmetic + a sorted
  ``segment_sum`` (our CSR-ordered pair lists make the segment reduction
  contiguous).
- Everything is pure jnp and jit-friendly, so ``jax.grad`` of the summed
  energies equals the analytical forces returned by
  :func:`coulomb_energy_forces` — the same contract the reference wires up
  through its Warp-tape autograd bridge (autograd.py:124-297).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.interactions.electrostatics._pairwise import (
    TWO_OVER_SQRT_PI,
    jax_erfc,
    pair_charge_gradients,
    pair_energies,
    pair_energies_forces,
)

__all__ = ["coulomb_energy", "coulomb_forces", "coulomb_energy_forces"]


def _validate_format(neighbor_list, neighbor_shifts, neighbor_matrix, neighbor_matrix_shifts):
    use_list = neighbor_list is not None
    use_matrix = neighbor_matrix is not None
    if use_list == use_matrix:
        raise ValueError(
            "Provide exactly one of neighbor_list(+neighbor_ptr/neighbor_shifts) "
            "or neighbor_matrix(+neighbor_matrix_shifts)"
        )
    return use_list


def _list_pair_terms(positions, charges, cell, idx_i, idx_j, shifts, cutoff, alpha, batch_idx):
    """Per-pair energy/force/charge-grad ingredients for the COO format (SoA)."""
    from nvalchemiops_tpu.interactions.electrostatics._pairwise import (
        _cartesian_shift_components,
    )

    dtype = positions.dtype
    aos = jnp.asarray(shifts).ndim == 2  # list layout: [P,3] AoS vs [P] packed
    shx, shy, shz = _cartesian_shift_components(
        shifts, cell, batch_idx, idx_i, dtype, aos
    )
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    dx = px[idx_j] + shx - px[idx_i]
    dy = py[idx_j] + shy - py[idx_i]
    dz = pz[idx_j] + shz - pz[idx_i]
    r2 = dx * dx + dy * dy + dz * dz
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0)) * (r2 > 0)
    cutoff_t = jnp.asarray(cutoff, dtype=dtype)
    alpha_t = jnp.asarray(alpha, dtype=dtype)
    if alpha_t.ndim == 1:  # per-atom alpha -> per-pair via the source atom
        alpha_t = alpha_t[idx_i]
    mask = (r < cutoff_t) & (r > 1e-10)
    r_safe = jnp.where(mask, r, 1.0)
    inv_r = 1.0 / r_safe
    ar = alpha_t * r_safe
    erfc_ar = jnp.asarray(jax_erfc(ar), dtype=dtype)
    damped = alpha_t > 0
    phi = jnp.where(damped, erfc_ar * inv_r, inv_r)
    mag = jnp.where(
        damped,
        erfc_ar * inv_r * inv_r * inv_r
        + TWO_OVER_SQRT_PI * alpha_t * jnp.exp(-ar * ar) * inv_r * inv_r,
        inv_r * inv_r * inv_r,
    )
    return (dx, dy, dz), mask, phi, mag


def coulomb_energy(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """Per-atom Coulomb energies (``E_i = 1/2 sum_j q_i q_j erfc(ar)/r``).

    Mirrors the reference wrapper (coulomb.py:1336-1489); see module
    docstring for the dtype policy.  Returns energies of shape (N,).
    """
    del neighbor_ptr  # CSR pointers are not needed by the gather formulation
    use_list = _validate_format(
        neighbor_list, neighbor_shifts, neighbor_matrix, neighbor_matrix_shifts
    )
    n = positions.shape[0]
    if use_list:
        idx_i = neighbor_list[0].astype(INDEX_DTYPE)
        idx_j = neighbor_list[1].astype(INDEX_DTYPE)
        if neighbor_shifts is None:
            neighbor_shifts = jnp.zeros((idx_i.shape[0], 3), dtype=INDEX_DTYPE)
        _d, mask, phi, _ = _list_pair_terms(
            positions, charges, cell, idx_i, idx_j, neighbor_shifts, cutoff, alpha, batch_idx
        )
        e_pair = 0.5 * charges[idx_i] * charges[idx_j] * phi
        return jax.ops.segment_sum(
            jnp.where(mask, e_pair, 0.0), idx_i, num_segments=n,
            indices_are_sorted=True,
        )
    if neighbor_matrix_shifts is None:
        neighbor_matrix_shifts = jnp.zeros(
            neighbor_matrix.shape + (3,), dtype=INDEX_DTYPE
        )
    return pair_energies(
        positions, charges, cell, neighbor_matrix, neighbor_matrix_shifts,
        cutoff, alpha, batch_idx=batch_idx, fill_value=fill_value,
    )


def coulomb_energy_forces(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """Per-atom energies and analytical forces (reference: coulomb.py:1540-1691).

    Requires full (non-half) neighbor data, like the reference kernels.
    Returns ``(energies [N], forces [N, 3])``.
    """
    del neighbor_ptr
    use_list = _validate_format(
        neighbor_list, neighbor_shifts, neighbor_matrix, neighbor_matrix_shifts
    )
    n = positions.shape[0]
    if use_list:
        idx_i = neighbor_list[0].astype(INDEX_DTYPE)
        idx_j = neighbor_list[1].astype(INDEX_DTYPE)
        if neighbor_shifts is None:
            neighbor_shifts = jnp.zeros((idx_i.shape[0], 3), dtype=INDEX_DTYPE)
        (dx, dy, dz), mask, phi, mag = _list_pair_terms(
            positions, charges, cell, idx_i, idx_j, neighbor_shifts, cutoff, alpha, batch_idx
        )
        qq = charges[idx_i] * charges[idx_j]
        e_pair = jnp.where(mask, 0.5 * qq * phi, 0.0)
        coef = jnp.where(mask, qq * mag, 0.0)
        energies = jax.ops.segment_sum(
            e_pair, idx_i, num_segments=n, indices_are_sorted=True
        )
        seg = lambda v: jax.ops.segment_sum(  # noqa: E731
            v, idx_i, num_segments=n, indices_are_sorted=True
        )
        forces = jnp.stack(
            [seg(coef * (-dx)), seg(coef * (-dy)), seg(coef * (-dz))], axis=-1
        )
        return energies, forces
    if neighbor_matrix_shifts is None:
        neighbor_matrix_shifts = jnp.zeros(
            neighbor_matrix.shape + (3,), dtype=INDEX_DTYPE
        )
    return pair_energies_forces(
        positions, charges, cell, neighbor_matrix, neighbor_matrix_shifts,
        cutoff, alpha, batch_idx=batch_idx, fill_value=fill_value,
    )


def coulomb_forces(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    **kwargs,
):
    """Forces only (reference: coulomb.py:1492-1538)."""
    _, forces = coulomb_energy_forces(
        positions, charges, cell, cutoff, alpha, **kwargs
    )
    return forces


def coulomb_charge_gradients(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """d(total energy)/d(charges), both neighbor formats, single or batched.

    For a full (double-counted) pair structure,
    ``dE/dq_i = sum_j q_j erfc(a r_ij)/r_ij`` — the per-atom electrostatic
    potential.  (Reference exposes this through the Ewald real-space
    charge-grad kernels for all four format/batch combinations,
    ewald_kernels.py:265-1494; here both formats share the pairwise core.)
    """
    del neighbor_ptr
    use_list = _validate_format(
        neighbor_list, neighbor_shifts, neighbor_matrix, neighbor_matrix_shifts
    )
    if use_list:
        n = positions.shape[0]
        idx_i = neighbor_list[0].astype(INDEX_DTYPE)
        idx_j = neighbor_list[1].astype(INDEX_DTYPE)
        if neighbor_shifts is None:
            neighbor_shifts = jnp.zeros((idx_i.shape[0], 3), dtype=INDEX_DTYPE)
        _d, mask, phi, _ = _list_pair_terms(
            positions, charges, cell, idx_i, idx_j, neighbor_shifts, cutoff,
            alpha, batch_idx,
        )
        cg_pair = jnp.where(mask, charges[idx_j] * phi, 0.0)
        return jax.ops.segment_sum(
            cg_pair, idx_i, num_segments=n, indices_are_sorted=True
        )
    if neighbor_matrix_shifts is None:
        neighbor_matrix_shifts = jnp.zeros(
            neighbor_matrix.shape + (3,), dtype=INDEX_DTYPE
        )
    return pair_charge_gradients(
        positions, charges, cell, neighbor_matrix, neighbor_matrix_shifts,
        cutoff, alpha, batch_idx=batch_idx, fill_value=fill_value,
    )
