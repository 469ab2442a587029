# SPDX-License-Identifier: Apache-2.0
"""Classical Ewald summation.

JAX counterpart of
``nvalchemiops/interactions/electrostatics/ewald.py`` (+ its 30+ Warp
kernels in ewald_kernels.py).  The physics is identical —

    E_recip = (1/2V) sum_{k in half-space} G(k) |S(k)|^2,
    G(k) = 8 pi exp(-k^2/(4 alpha^2)) / k^2          (half-space doubling)
    S(k) = sum_j q_j exp(i k.r_j)
    E_self,i = (alpha/sqrt(pi)) q_i^2
    E_bg,i  = (pi / (2 alpha^2)) q_i Q_total / V

— but the K-major / atom-major scalar loops of the reference
(ewald_kernels.py:1495-1979) become dense matmuls: phases are
``positions @ k_vectors^T`` tiles, structure factors are charge-weighted
row sums, and per-atom energies/forces/charge-gradients are second matmuls
against the weighted structure factors.  Batched systems are packed into a
padded [B, n_max] layout (pure gathers, since concatenated systems are
contiguous) so everything runs as one batched GEMM; k-space is processed in
bounded chunks under ``lax.scan``.

Real space delegates to the shared damped-Coulomb core (coulomb.py), exactly
like the reference shares its real-space kernels between Coulomb and Ewald.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.interactions.electrostatics.coulomb import (
    coulomb_charge_gradients,
    coulomb_energy,
    coulomb_energy_forces,
)
from nvalchemiops_tpu.interactions.electrostatics.k_vectors import (
    generate_k_vectors_ewald_summation,
)
from nvalchemiops_tpu.mathops.math import dot_phases
from nvalchemiops_tpu.interactions.electrostatics.parameters import (
    estimate_ewald_parameters,
)

__all__ = ["ewald_real_space", "ewald_reciprocal_space", "ewald_summation"]

SQRT_PI = math.sqrt(math.pi)
EIGHTPI = 8.0 * math.pi


# ---------------------------------------------------------------------------
# Real space (reference: ewald.py:2321-2628)
# ---------------------------------------------------------------------------


def ewald_real_space(
    positions,
    charges,
    cell,
    alpha,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int = -1,
    batch_idx=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    cutoff: float | None = None,
):
    """erfc-damped real-space term; dispatches on the requested outputs.

    Return patterns match the reference (ewald.py:2321-2628):
    ``energies``, ``(energies, forces)``, ``(energies, charge_grads)`` or
    ``(energies, forces, charge_grads)``.  ``cutoff`` defaults to unbounded
    (pairs are whatever the neighbor structure contains), matching the
    reference kernels which apply no extra distance filter in real space.
    """
    if cutoff is None:
        cutoff = jnp.inf
    alpha_arr = jnp.asarray(alpha, dtype=positions.dtype).reshape(-1)
    if alpha_arr.shape[0] > 1:
        if batch_idx is None:
            raise ValueError("Per-system alpha requires batch_idx")
        # per-atom alpha broadcasts through the pairwise cores
        alpha_atom = alpha_arr[batch_idx.astype(INDEX_DTYPE)]
        alpha_scalar = (
            alpha_atom[:, None] if neighbor_matrix is not None else alpha_atom
        )  # [N,1] broadcasts over [N,K]; [N] is gathered per pair in list mode
    else:
        alpha_scalar = alpha_arr[0]

    kwargs = dict(
        neighbor_list=neighbor_list,
        neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts,
        neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        fill_value=mask_value,
        batch_idx=batch_idx,
    )
    if compute_forces:
        energies, forces = coulomb_energy_forces(
            positions, charges, cell, cutoff, alpha_scalar, **kwargs
        )
    else:
        energies = coulomb_energy(
            positions, charges, cell, cutoff, alpha_scalar, **kwargs
        )
        forces = None
    if compute_charge_gradients:
        cg = coulomb_charge_gradients(
            positions, charges, cell, cutoff, alpha_scalar,
            neighbor_list=neighbor_list,
            neighbor_shifts=neighbor_shifts,
            neighbor_matrix=neighbor_matrix,
            neighbor_matrix_shifts=neighbor_matrix_shifts,
            fill_value=mask_value,
            batch_idx=batch_idx,
        )
    else:
        cg = None

    if forces is not None and cg is not None:
        return energies, forces, cg
    if forces is not None:
        return energies, forces
    if cg is not None:
        return energies, cg
    return energies


# ---------------------------------------------------------------------------
# Reciprocal space (reference: ewald.py:2631-2795, ewald_kernels.py:1495-2460)
# ---------------------------------------------------------------------------


def _pad_layout(batch_idx, batch_ptr, num_systems: int, n_max: int, n: int):
    """Gather maps between the concatenated [N] and padded [B, n_max] layouts."""
    p = jnp.arange(n_max, dtype=INDEX_DTYPE)
    flat_idx = batch_ptr[:-1, None] + p[None, :]  # [B, n_max]
    counts = batch_ptr[1:] - batch_ptr[:-1]
    pad_valid = p[None, :] < counts[:, None]
    flat_idx = jnp.clip(flat_idx, 0, max(n - 1, 0))
    # flat -> (b, p) for reading padded results back
    atom_b = batch_idx.astype(INDEX_DTYPE)
    atom_p = jnp.arange(n, dtype=INDEX_DTYPE) - batch_ptr[atom_b]
    return flat_idx, pad_valid, atom_b, atom_p


@partial(
    jax.jit,
    static_argnames=("n_max", "num_systems", "compute_forces", "compute_charge_gradients", "k_chunk"),
)
def _reciprocal_core(
    positions,
    charges,
    cell_b,
    k_vectors_b,
    alpha_b,
    batch_idx,
    batch_ptr,
    n_max: int,
    num_systems: int,
    compute_forces: bool,
    compute_charge_gradients: bool,
    k_chunk: int = 512,
):
    """Padded-batch, K-chunked reciprocal-space evaluation."""
    n = positions.shape[0]
    dtype = positions.dtype

    flat_idx, pad_valid, atom_b, atom_p = _pad_layout(
        batch_idx, batch_ptr, num_systems, n_max, n
    )
    pos_pad = positions[flat_idx] * pad_valid[..., None]  # [B, n_max, 3]
    q_pad = charges[flat_idx] * pad_valid  # [B, n_max]

    volume = jnp.abs(jnp.linalg.det(cell_b))  # [B]
    alpha = jnp.broadcast_to(alpha_b.reshape(-1), (num_systems,)).astype(dtype)

    total_k = k_vectors_b.shape[1]
    num_chunks = -(-total_k // k_chunk)
    k_pad = num_chunks * k_chunk
    kv = jnp.pad(k_vectors_b, ((0, 0), (0, k_pad - total_k), (0, 0)))
    k_valid = jnp.arange(k_pad) < total_k

    exp_factor = (0.25 / (alpha * alpha))[:, None]  # [B, 1]

    def chunk_body(carry, start):
        e_pad, f_pad, cg_pad = carry
        zero = jnp.zeros((), INDEX_DTYPE)
        kc = jax.lax.dynamic_slice(
            kv, (zero, start, zero), (num_systems, k_chunk, 3)
        )  # [B, C, 3]
        kvalid = jax.lax.dynamic_slice(k_valid, (start,), (k_chunk,))
        k_sq = jnp.sum(kc * kc, axis=-1)  # [B, C]
        good = (k_sq > 1e-10) & kvalid[None, :]
        k_sq_safe = jnp.where(good, k_sq, 1.0)
        green = jnp.where(
            good,
            jnp.exp(-exp_factor * k_sq_safe) / k_sq_safe * EIGHTPI / volume[:, None],
            0.0,
        )  # [B, C]

        # phases k.r elementwise in exact f32 — a reduced-precision K=3
        # contraction truncates coordinates (8e-3 relative energy error
        # with bf16 operands); see mathops.dot_phases
        phase = dot_phases(pos_pad, kc)  # [B, n_max, C]
        cos_p = jnp.cos(phase)
        sin_p = jnp.sin(phase)
        # structure-factor / per-atom reductions contract exact f32 cos/sin
        # values at HIGH precision (1.2e-6 end accuracy at the 64x2000
        # batch config)
        hi = jax.lax.Precision.HIGH
        s_re = jnp.einsum("bn,bnc->bc", q_pad, cos_p, precision=hi) * green
        s_im = jnp.einsum("bn,bnc->bc", q_pad, sin_p, precision=hi) * green

        e_pad = e_pad + 0.5 * q_pad * (
            jnp.einsum("bc,bnc->bn", s_re, cos_p, precision=hi)
            + jnp.einsum("bc,bnc->bn", s_im, sin_p, precision=hi)
        )
        if compute_forces:
            # F_i = q_i sum_k k [sin(k.r_i) S_re_w - cos(k.r_i) S_im_w]
            term = sin_p * s_re[:, None, :] - cos_p * s_im[:, None, :]
            f_pad = f_pad + q_pad[..., None] * jnp.stack(
                [jnp.sum(term * kc[:, None, :, d], axis=-1)
                 for d in range(3)], axis=-1)
        if compute_charge_gradients:
            cg_pad = cg_pad + (
                jnp.einsum("bc,bnc->bn", s_re, cos_p, precision=hi)
                + jnp.einsum("bc,bnc->bn", s_im, sin_p, precision=hi)
            )
        return (e_pad, f_pad, cg_pad), None

    init = (
        jnp.zeros((num_systems, n_max), dtype=dtype),
        jnp.zeros((num_systems, n_max, 3), dtype=dtype),
        jnp.zeros((num_systems, n_max), dtype=dtype),
    )
    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * k_chunk
    (e_pad, f_pad, cg_pad), _ = jax.lax.scan(chunk_body, init, starts)

    # corrections (reference: ewald_kernels.py:1691-1759)
    q_total = jnp.sum(q_pad, axis=1)  # [B]
    self_term = (alpha[:, None] / SQRT_PI) * q_pad * q_pad
    bg_term = (
        math.pi
        / (2.0 * alpha[:, None] ** 2)
        * q_pad
        * (q_total / volume)[:, None]
    )
    e_pad = e_pad - self_term - bg_term
    if compute_charge_gradients:
        cg_pad = cg_pad - 2.0 * alpha[:, None] / SQRT_PI * q_pad - (
            math.pi / (alpha[:, None] ** 2) * (q_total / volume)[:, None]
        )

    # back to the concatenated layout (pure gather)
    energies = e_pad[atom_b, atom_p]
    forces = f_pad[atom_b, atom_p] if compute_forces else None
    cg = cg_pad[atom_b, atom_p] if compute_charge_gradients else None
    return energies, forces, cg


def ewald_reciprocal_space(
    positions,
    charges,
    cell,
    k_vectors,
    alpha,
    batch_idx=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    batch_ptr=None,
):
    """Reciprocal-space energies (+forces, +charge grads), self/background corrected.

    Same return patterns as the reference (ewald.py:2631-2795).  For batched
    systems, pass ``batch_idx`` (atoms concatenated per system, contiguous);
    ``k_vectors`` may be [K, 3] (shared) or [B, K, 3].
    """
    dtype = positions.dtype
    n = positions.shape[0]
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    num_systems = cell_b.shape[0]

    kv = jnp.asarray(k_vectors, dtype=dtype)
    if kv.ndim == 2:
        kv = jnp.broadcast_to(kv[None], (num_systems,) + kv.shape)

    if batch_idx is None:
        batch_idx_arr = jnp.zeros((n,), dtype=INDEX_DTYPE)
        batch_ptr_arr = jnp.asarray([0, n], dtype=INDEX_DTYPE)
        n_max = n
    else:
        from nvalchemiops_tpu.neighborlist.neighbor_utils import prepare_batch_idx_ptr

        batch_idx_arr, batch_ptr_arr = prepare_batch_idx_ptr(batch_idx, batch_ptr, n)
        counts = np.diff(np.asarray(jax.device_get(batch_ptr_arr)))
        n_max = int(counts.max()) if counts.size else 0

    alpha_arr = jnp.asarray(alpha, dtype=dtype).reshape(-1)
    energies, forces, cg = _reciprocal_core(
        positions,
        charges,
        cell_b,
        kv,
        alpha_arr,
        batch_idx_arr,
        batch_ptr_arr,
        n_max,
        num_systems,
        compute_forces,
        compute_charge_gradients,
    )
    if forces is not None and cg is not None:
        return energies, forces, cg
    if forces is not None:
        return energies, forces
    if cg is not None:
        return energies, cg
    return energies


# ---------------------------------------------------------------------------
# Full summation (reference: ewald.py:2798-3050)
# ---------------------------------------------------------------------------


def ewald_summation(
    positions,
    charges,
    cell,
    alpha=None,
    k_vectors=None,
    k_cutoff: float | None = None,
    batch_idx=None,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int | None = None,
    compute_forces: bool = False,
    accuracy: float = 1e-6,
):
    """Real + reciprocal Ewald summation with optional parameter estimation.

    Returns per-atom energies (and forces when ``compute_forces``), like the
    reference wrapper (ewald.py:2798-3050).
    """
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    if mask_value is None:
        mask_value = positions.shape[0]

    if alpha is None or (k_vectors is None and k_cutoff is None):
        params = estimate_ewald_parameters(positions, cell_b, batch_idx, accuracy)
        if alpha is None:
            alpha = params.alpha
        if k_vectors is None and k_cutoff is None:
            k_cutoff = params.reciprocal_space_cutoff
    if k_vectors is None:
        k_vectors = generate_k_vectors_ewald_summation(cell_b, k_cutoff)

    alpha_arr = jnp.asarray(alpha, dtype=dtype).reshape(-1)
    alpha_real = alpha_arr[0]

    real = ewald_real_space(
        positions, charges, cell_b, alpha_real,
        neighbor_list=neighbor_list,
        neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts,
        neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        mask_value=mask_value,
        batch_idx=batch_idx,
        compute_forces=compute_forces,
    )
    recip = ewald_reciprocal_space(
        positions, charges, cell_b, k_vectors, alpha_arr,
        batch_idx=batch_idx,
        compute_forces=compute_forces,
    )
    if compute_forces:
        e_r, f_r = real
        e_k, f_k = recip
        return e_r + e_k, f_r + f_k
    return real + recip
