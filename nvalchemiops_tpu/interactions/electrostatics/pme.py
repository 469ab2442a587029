# SPDX-License-Identifier: Apache-2.0
"""Particle Mesh Ewald (PME) reciprocal-space electrostatics.

JAX counterpart of
``nvalchemiops/interactions/electrostatics/pme.py`` (pipeline at
pme.py:1338-1479, public API at :1482-1994) and the Green's-function /
correction kernels in ``pme_kernels.py:120-664``.  Pipeline:

    spline_spread -> rfftn -> (/ |B(k)|^2) * G(k) -> irfftn -> spline_gather
    -> self/background corrections.  Forces depart from the reference's
    ik-space path (3 irfftns + vec3 gather, pme.py:1450-1477): they are the
    analytic spline-derivative gradient of the discrete energy on the single
    potential mesh (F = -dE/dr exactly, one irfftn total), sharing the
    tile-windowed stencil of ``spline_windowed.py`` with the energy gather.

Conventions identical to the reference:

- ``G(k) = 2 pi exp(-k^2/(4 alpha^2)) / (V k^2)`` (half of 4 pi because the
  per-atom energy is ``E_i = q_i phi_i`` without the pairwise 1/2),
- B-spline dealiasing ``C(k) = [sinc(mx/nx) sinc(my/ny) sinc(mz/nz)]^order``
  squared (one factor each for spreading and gathering),
- FFT normalization: unscaled forward (``norm='backward'``) and unscaled
  inverse (``norm='forward'``),
- corrections ``E_i -= (alpha/sqrt(pi)) q_i^2 + (pi/(2 alpha^2 V)) q_i Q``.

Every stage is a dense XLA op (FFTs, broadcasts, the spline module's
gathers), so the whole pipeline fuses, jits, shards, and differentiates —
the Warp-tape plumbing of the reference collapses into plain jnp.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.spline import (
    spline_gather,
    spline_gather_gradient,
    spline_spread,
)
from nvalchemiops_tpu.mathops.math import apply_mat3, sinc_normalized
from nvalchemiops_tpu.interactions.electrostatics.ewald import ewald_real_space
from nvalchemiops_tpu.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_tpu.interactions.electrostatics.parameters import (
    estimate_ewald_parameters,
    estimate_pme_mesh_dimensions,
    mesh_spacing_to_dimensions,
)
from nvalchemiops_tpu.types import INDEX_DTYPE

__all__ = ["pme_reciprocal_space", "particle_mesh_ewald",
           "grid_particle_mesh_ewald",
           "pme_green_structure_factor", "batch_pme_reciprocal"]

TWOPI = 2.0 * math.pi
SQRT_PI = math.sqrt(math.pi)


def pme_green_structure_factor(k_squared, mesh_dimensions, alpha, cell, spline_order: int):
    """Green's function and |B(k)|^2 dealiasing factor on the rfft grid.

    (reference: pme_kernels.py:120-338.)  Supports a leading batch axis on
    ``k_squared`` / ``cell`` / ``alpha``.

    Returns ``(green [.., nx, ny, nz//2+1], structure_factor_sq)``.
    """
    nx, ny, nz = mesh_dimensions
    ks = jnp.asarray(k_squared)
    batched = ks.ndim == 4
    dtype = ks.dtype

    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    volume = jnp.abs(jnp.linalg.det(cell_b))  # [B]
    alpha_b = jnp.broadcast_to(
        jnp.asarray(alpha, dtype=dtype).reshape(-1), (cell_b.shape[0],)
    )
    if not batched:
        volume = volume[0]
        alpha_b = alpha_b[0]
        expand = lambda x: x  # noqa: E731
    else:
        expand = lambda x: x[:, None, None, None]  # noqa: E731

    good = ks > 1e-10
    ks_safe = jnp.where(good, ks, 1.0)
    green = jnp.where(
        good,
        TWOPI
        * jnp.exp(-expand(0.25 / (alpha_b * alpha_b)) * ks_safe)
        / (ks_safe * expand(volume)),
        0.0,
    )

    mx = (jnp.fft.fftfreq(nx) * nx).astype(dtype)
    my = (jnp.fft.fftfreq(ny) * ny).astype(dtype)
    mz = (jnp.fft.rfftfreq(nz) * nz).astype(dtype)
    sinc3 = (
        sinc_normalized(mx / nx)[:, None, None]
        * sinc_normalized(my / ny)[None, :, None]
        * sinc_normalized(mz / nz)[None, None, :]
    )
    sf = jnp.maximum(sinc3**spline_order, 1e-10)
    sf_sq = sf * sf
    if batched:
        sf_sq = jnp.broadcast_to(sf_sq[None], ks.shape)
    return green, sf_sq


@partial(
    jax.jit,
    static_argnames=(
        "mesh_dimensions",
        "spline_order",
        "compute_forces",
        "compute_charge_gradients",
        "tile_capacity",
        "fft_mode",
    ),
)
def _pme_reciprocal_impl(
    positions,
    charges,
    cell,
    alpha,
    mesh_dimensions,
    spline_order,
    batch_idx,
    compute_forces,
    compute_charge_gradients,
    k_vectors,
    k_squared,
    tile_capacity=None,
    fft_mode: str = "xla",
):
    """Core pipeline (reference: pme.py:1338-1479), compiled as one program."""
    dtype = positions.dtype
    n = positions.shape[0]
    is_batch = batch_idx is not None
    fft_axes = (1, 2, 3) if is_batch else (0, 1, 2)
    nx, ny, nz = mesh_dimensions

    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    num_systems = cell_b.shape[0]
    alpha_b = jnp.broadcast_to(
        jnp.asarray(alpha, dtype=dtype).reshape(-1), (num_systems,)
    )

    # 1. spread charges.  Single-system: tile-windowed fast path with shared
    # tiles reused by the gather/force stage (spline_windowed.py); batch:
    # scatter-add path.
    from nvalchemiops_tpu import spline_windowed as sw

    use_win = (not is_batch) and sw.windowed_applicable(mesh_dimensions, spline_order)
    tiles = None
    if use_win:
        # tile_capacity: observed-occupancy override
        # (sw.observed_tile_capacity) — the dense lax.cond fallback below
        # still guards overflow if atoms moved since it was measured
        cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions)
        tiles = sw.build_mesh_tiles(
            positions, cell_b[0], mesh_dimensions, spline_order, cap,
            need_grad=compute_forces,
        )
        from nvalchemiops_tpu.spline import _separable_spread, _stencil_axis_matrices

        tiles_ok = tiles.counts_max <= cap

        def _dense_spread(_):
            (sx, sy, sz), _u = _stencil_axis_matrices(
                positions, cell_b[0], mesh_dimensions, spline_order, None
            )
            return _separable_spread(charges, sx, sy, sz)

        with jax.named_scope("pme.spread"):
            mesh = jax.lax.cond(
                tiles_ok,
                lambda _: sw.windowed_spread(tiles, charges),
                _dense_spread, None,
            )
    else:
        mesh = spline_spread(
            positions, charges, cell_b if is_batch else cell_b[0],
            mesh_dims=mesh_dimensions, spline_order=spline_order, batch_idx=batch_idx,
        )
        if is_batch and mesh.ndim == 3:
            mesh = mesh[None]

    # 2./3. Green's function + dealiasing
    if k_vectors is None or k_squared is None:
        k_vectors, k_squared = generate_k_vectors_pme(
            cell_b if is_batch else cell_b[0], mesh_dimensions
        )
    green, sf_sq = pme_green_structure_factor(
        k_squared, mesh_dimensions,
        alpha_b if is_batch else alpha_b[0],
        cell_b if is_batch else cell_b[0],
        spline_order,
    )

    # 4./5. FFT, convolve, inverse FFT -> potential mesh
    with jax.named_scope("pme.convolve"):
        if fft_mode == "matmul":
            from nvalchemiops_tpu.mathops.matmul_dft import (
                matmul_rfft_convolve,
            )

            potential_mesh = matmul_rfft_convolve(mesh, green / sf_sq)
        else:
            mesh_fft = jnp.fft.rfftn(mesh, norm="backward", axes=fft_axes)
            convolved = mesh_fft / sf_sq * green
            potential_mesh = jnp.fft.irfftn(
                convolved, s=mesh_dimensions, norm="forward", axes=fft_axes
            ).astype(dtype)

    # 6. gather potential (and, for forces, its spline-derivative gradient)
    # at atoms.  Forces use the analytic gradient of the *discrete* energy —
    # one irfftn total instead of the reference's three ik-space E-field
    # transforms + vec3 gather (pme.py:1450-1477); with the factor 2 below
    # this equals -dE/dr exactly (the spread-side dependence contributes an
    # identical term by the symmetry of the convolution).
    grad_frac = None
    if use_win:
        def _win_gather(_):
            if compute_forces:
                return sw.windowed_gather(tiles, potential_mesh, with_gradient=True)
            return sw.windowed_gather(tiles, potential_mesh), jnp.zeros((n, 3), dtype)

        def _dense_gather(_):
            r = spline_gather(
                positions, potential_mesh, cell_b[0], spline_order=spline_order
            )
            if compute_forces:
                g = -spline_gather_gradient(
                    positions, jnp.ones_like(charges), potential_mesh, cell_b[0],
                    spline_order=spline_order,
                ) @ jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)[0].T
                return r, g
            return r, jnp.zeros((n, 3), dtype)

        with jax.named_scope("pme.gather"):
            raw, grad_frac = jax.lax.cond(
                tiles_ok, _win_gather, _dense_gather, None)
    else:
        raw = spline_gather(
            positions, potential_mesh, cell_b if is_batch else cell_b[0],
            spline_order=spline_order, batch_idx=batch_idx,
        )

    # 7. corrections (reference: pme_kernels.py:339-494)
    volume = jnp.abs(jnp.linalg.det(cell_b))  # [B]
    if is_batch:
        b_of = batch_idx.astype(INDEX_DTYPE)
        q_total = jax.ops.segment_sum(charges, b_of, num_segments=num_systems)
        alpha_a = alpha_b[b_of]
        vol_a = volume[b_of]
        q_tot_a = q_total[b_of]
    else:
        alpha_a = alpha_b[0]
        vol_a = volume[0]
        q_tot_a = jnp.sum(charges)

    energies = (
        charges * raw
        - (alpha_a / SQRT_PI) * charges * charges
        - (math.pi / (2.0 * alpha_a**2)) * charges * q_tot_a / vol_a
    )

    charge_grads = None
    if compute_charge_gradients:
        charge_grads = (
            2.0 * raw
            - 2.0 * (alpha_a / SQRT_PI) * charges
            - (math.pi / (alpha_a**2)) * q_tot_a / vol_a
        )

    forces = None
    if compute_forces:
        if use_win:
            forces = 2.0 * apply_mat3(-charges[:, None] * grad_frac, tiles.inv.T)
        else:
            forces = 2.0 * spline_gather_gradient(
                positions, charges, potential_mesh,
                cell_b if is_batch else cell_b[0],
                spline_order=spline_order, batch_idx=batch_idx,
            )
        # Smooth-PME gradient forces conserve energy exactly but carry a
        # mesh-accuracy net force (the discrete energy is not exactly
        # translation invariant); remove it uniformly, the standard SPME
        # remedy, so momentum is conserved like the reference's ik path.
        if is_batch:
            b_of2 = batch_idx.astype(INDEX_DTYPE)
            counts = jax.ops.segment_sum(
                jnp.ones_like(charges), b_of2, num_segments=num_systems
            )
            net = jax.ops.segment_sum(forces, b_of2, num_segments=num_systems)
            forces = forces - net[b_of2] / jnp.maximum(counts[b_of2], 1.0)[:, None]
        else:
            forces = forces - jnp.mean(forces, axis=0, keepdims=True)

    return energies, forces, charge_grads


def _check_mesh_engines(spread_engine: str, gather_engine: str):
    """The windowed spread and gather have one engine, plain XLA."""
    for name, value in (("spread_engine", spread_engine),
                        ("gather_engine", gather_engine)):
        if value != "xla":
            raise ValueError(f"unknown PME {name} {value!r}; expected 'xla'")


def pme_reciprocal_space(
    positions,
    charges,
    cell,
    alpha,
    mesh_dimensions=None,
    mesh_spacing=None,
    spline_order: int = 4,
    batch_idx=None,
    k_vectors=None,
    k_squared=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    accuracy: float = 1e-6,
    tile_capacity: int | None = None,
    fft_mode: str = "xla",
    gather_engine: str = "xla",
    spread_engine: str = "xla",
):
    """FFT-based reciprocal-space PME (reference: pme.py:1482-1665).

    Return patterns: ``energies``, ``(energies, forces)``,
    ``(energies, charge_grads)``, ``(energies, forces, charge_grads)``.

    ``tile_capacity`` overrides the Poisson-safe windowed-spread tile
    capacity with an observed one
    (:func:`spline_windowed.observed_tile_capacity`) — per-tile work
    scales ~capacity, and crystals sit far below the safe bound.

    ``fft_mode="matmul"`` runs the whole FFT-convolve-inverse as dense
    matmuls (``mathops.matmul_dft``) — the small-batched-mesh path.
    ``spread_engine``/``gather_engine``: ``"xla"``, the only engine;
    other names raise ``ValueError``.
    """
    _check_mesh_engines(spread_engine, gather_engine)
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    alpha_arr = jnp.asarray(alpha, dtype=dtype).reshape(-1)
    if mesh_dimensions is None:
        if mesh_spacing is not None:
            mesh_dimensions = mesh_spacing_to_dimensions(cell_b, mesh_spacing)
        else:
            mesh_dimensions = estimate_pme_mesh_dimensions(cell_b, alpha_arr, accuracy)

    energies, forces, cg = _pme_reciprocal_impl(
        positions, charges, cell_b, alpha_arr, tuple(mesh_dimensions), spline_order,
        batch_idx, compute_forces, compute_charge_gradients, k_vectors, k_squared,
        tile_capacity=tile_capacity, fft_mode=fft_mode,
    )
    if forces is not None and cg is not None:
        return energies, forces, cg
    if forces is not None:
        return energies, forces
    if cg is not None:
        return energies, cg
    return energies


def particle_mesh_ewald(
    positions,
    charges,
    cell,
    alpha=None,
    mesh_spacing=None,
    mesh_dimensions=None,
    spline_order: int = 4,
    batch_idx=None,
    k_vectors=None,
    k_squared=None,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int | None = None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    accuracy: float = 1e-6,
):
    """Full PME: real space + reciprocal space (reference: pme.py:1673-1994).

    Same return patterns as :func:`pme_reciprocal_space`; per-atom energies.
    """
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    num_atoms = positions.shape[0]
    if mask_value is None:
        mask_value = num_atoms
    if alpha is None:
        params = estimate_ewald_parameters(positions, cell_b, batch_idx, accuracy)
        alpha = params.alpha
    alpha_arr = jnp.asarray(alpha, dtype=dtype).reshape(-1)

    if mesh_dimensions is None:
        if mesh_spacing is not None:
            mesh_dimensions = mesh_spacing_to_dimensions(cell_b, mesh_spacing)
        else:
            mesh_dimensions = estimate_pme_mesh_dimensions(cell_b, alpha_arr, accuracy)

    rs = ewald_real_space(
        positions, charges, cell_b, alpha_arr,
        neighbor_list=neighbor_list,
        neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts,
        neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        mask_value=mask_value,
        batch_idx=batch_idx,
        compute_forces=compute_forces,
        compute_charge_gradients=compute_charge_gradients,
    )
    rec = pme_reciprocal_space(
        positions, charges, cell_b, alpha_arr,
        mesh_dimensions=mesh_dimensions,
        spline_order=spline_order,
        batch_idx=batch_idx,
        compute_forces=compute_forces,
        compute_charge_gradients=compute_charge_gradients,
        k_vectors=k_vectors,
        k_squared=k_squared,
    )
    if compute_forces or compute_charge_gradients:
        return tuple(a + b for a, b in zip(rs, rec))
    return rs + rec


def _windowed_pme_single(positions, charges, cell, alpha, mesh_dimensions,
                         spline_order: int, cap: int, compute_forces: bool,
                         fft_mode: str = "xla",
                         compute_charge_gradients: bool = False,
                         tile: int = 8):
    """One system through the tile-windowed PME pipeline (vmappable).

    Lean straight-line version of :func:`_pme_reciprocal_impl`'s windowed
    path (no dense fallback cond — atoms beyond ``cap`` per tile are an
    error here), shared by the batched fast path below and
    ``parallel.domain.domain_pme_reciprocal``.
    """
    from nvalchemiops_tpu import spline_windowed as sw

    dtype = positions.dtype
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                spline_order, cap, tile=tile,
                                need_grad=compute_forces)
    mesh = sw.windowed_spread(tiles, charges)
    _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    green, sf_sq = pme_green_structure_factor(
        k_squared, mesh_dimensions, alpha, cell, spline_order)
    if fft_mode == "matmul":
        # small batched meshes: the whole convolution as dense matmuls
        # (mathops/matmul_dft.py) — no complex tensors, no XLA FFT
        from nvalchemiops_tpu.mathops.matmul_dft import matmul_rfft_convolve

        potential_mesh = matmul_rfft_convolve(mesh, green / sf_sq)
    else:
        mesh_fft = jnp.fft.rfftn(mesh, norm="backward")
        potential_mesh = jnp.fft.irfftn(
            mesh_fft / sf_sq * green, s=mesh_dimensions,
            norm="forward").astype(dtype)

    if compute_forces:
        raw, grad_frac = sw.windowed_gather(tiles, potential_mesh,
                                            with_gradient=True)
    else:
        raw = sw.windowed_gather(tiles, potential_mesh)
        grad_frac = None

    alpha_t = jnp.asarray(alpha, dtype).reshape(())
    volume = jnp.abs(jnp.linalg.det(jnp.asarray(cell, dtype).reshape(3, 3)))
    q_total = jnp.sum(charges)
    energies = (
        charges * raw
        - (alpha_t / SQRT_PI) * charges * charges
        - (math.pi / (2.0 * alpha_t * alpha_t * volume)) * charges * q_total
    )
    charge_grads = None
    if compute_charge_gradients:
        # d(sum E)/dq_k: the spread-side dependence doubles raw_k by the
        # symmetry of the convolution (same identity as the force path)
        charge_grads = (
            2.0 * raw
            - 2.0 * (alpha_t / SQRT_PI) * charges
            - (math.pi / (alpha_t * alpha_t * volume)) * q_total
        )
    if not compute_forces:
        return energies, None, charge_grads
    forces = 2.0 * apply_mat3(-charges[:, None] * grad_frac, tiles.inv.T)
    forces = forces - jnp.mean(forces, axis=0, keepdims=True)
    return energies, forces, charge_grads


@partial(
    jax.jit,
    static_argnames=("mesh_dimensions", "spline_order", "cap",
                     "compute_forces", "fft_mode",
                     "compute_charge_gradients", "tile"),
)
def _batch_windowed_pme_impl(positions, charges, cells, alphas,
                             mesh_dimensions, spline_order, cap,
                             compute_forces, fft_mode="xla",
                             compute_charge_gradients=False,
                             tile=8):
    return jax.vmap(
        lambda p, q, c, a: _windowed_pme_single(
            p, q, c, a, mesh_dimensions, spline_order, cap, compute_forces,
            fft_mode=fft_mode,
            compute_charge_gradients=compute_charge_gradients,
            tile=tile)
    )(positions, charges, cells, alphas)


def _dense_pme_single(positions, charges, cell, alpha, mesh_dimensions,
                      spline_order: int, compute_forces: bool,
                      fft_mode: str = "xla",
                      compute_charge_gradients: bool = False):
    """One system through the dense separable-matmul PME pipeline (vmappable).

    No mesh tiles at all: spread/gather are the chunked separable matmuls
    (spline.py ``dense_*_single``).  They bypass the public
    spline_spread/gather entry points, whose single-system auto-select
    would route back to the tile-windowed path at windowed-applicable
    meshes.
    """
    from nvalchemiops_tpu.spline import (
        dense_gather_gradient_single,
        dense_gather_single,
        dense_spread_single,
    )

    dtype = positions.dtype
    mesh = dense_spread_single(positions, charges, cell, mesh_dimensions,
                               spline_order=spline_order)
    _, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    green, sf_sq = pme_green_structure_factor(
        k_squared, mesh_dimensions, alpha, cell, spline_order)
    if fft_mode == "matmul":
        from nvalchemiops_tpu.mathops.matmul_dft import matmul_rfft_convolve

        potential_mesh = matmul_rfft_convolve(mesh, green / sf_sq)
    else:
        mesh_fft = jnp.fft.rfftn(mesh, norm="backward")
        potential_mesh = jnp.fft.irfftn(
            mesh_fft / sf_sq * green, s=mesh_dimensions,
            norm="forward").astype(dtype)

    raw = dense_gather_single(positions, potential_mesh, cell,
                              spline_order=spline_order)

    alpha_t = jnp.asarray(alpha, dtype).reshape(())
    volume = jnp.abs(jnp.linalg.det(jnp.asarray(cell, dtype).reshape(3, 3)))
    q_total = jnp.sum(charges)
    energies = (
        charges * raw
        - (alpha_t / SQRT_PI) * charges * charges
        - (math.pi / (2.0 * alpha_t * alpha_t * volume)) * charges * q_total
    )
    charge_grads = None
    if compute_charge_gradients:
        charge_grads = (
            2.0 * raw
            - 2.0 * (alpha_t / SQRT_PI) * charges
            - (math.pi / (alpha_t * alpha_t * volume)) * q_total
        )
    if not compute_forces:
        return energies, None, charge_grads
    forces = 2.0 * dense_gather_gradient_single(
        positions, charges, potential_mesh, cell, spline_order=spline_order)
    forces = forces - jnp.mean(forces, axis=0, keepdims=True)
    return energies, forces, charge_grads


@partial(
    jax.jit,
    static_argnames=("mesh_dimensions", "spline_order", "compute_forces",
                     "fft_mode", "compute_charge_gradients"),
)
def _batch_dense_pme_impl(positions, charges, cells, alphas,
                          mesh_dimensions, spline_order,
                          compute_forces, fft_mode="xla",
                          compute_charge_gradients=False):
    return jax.vmap(
        lambda p, q, c, a: _dense_pme_single(
            p, q, c, a, mesh_dimensions, spline_order, compute_forces,
            fft_mode=fft_mode,
            compute_charge_gradients=compute_charge_gradients)
    )(positions, charges, cells, alphas)


def batch_pme_reciprocal(positions, charges, cells, alpha, mesh_dimensions,
                         spline_order: int = 4, compute_forces: bool = False,
                         tile_capacity: int | None = None,
                         fft_mode: str = "auto",
                         compute_charge_gradients: bool = False,
                         engine: str = "auto",
                         spread_engine: str = "xla",
                         gather_engine: str = "xla",
                         tile: int | None = None):
    """Batched reciprocal-space PME on uniform [B, n, 3] system stacks.

    The concatenated ``batch_idx`` path of :func:`pme_reciprocal_space`
    spreads with scatter-adds; uniform batches instead vmap a per-system
    pipeline (the reference's H100 number at 64 x 2,000 atoms is 5.76 ms
    energies-only).

    ``fft_mode="auto"`` (default) picks the matmul-DFT convolution for
    small per-system meshes (<= 32^3 points) and the XLA FFT for larger
    ones.  The crossover was tuned on an earlier accelerator and is to be
    measured again on the GPU.

    ``engine`` selects the per-system spread/gather implementation:

    - ``"dense"`` — tile-free chunked separable matmuls (no tile build,
      no capacity padding).
    - ``"windowed"`` — tile-windowed, shared tiles reused by the force
      gather (the per-tile [cap, W^3] expansion dominates small meshes).  ``spread_engine``/
      ``gather_engine`` accept ``"xla"`` only, as in
      :func:`pme_reciprocal_space`.
    - ``"auto"`` (default) — dense for per-system meshes up to 32^3
      points, windowed above (the dense [n, ny*nz] intermediate scales
      with the mesh; the crossover is unmeasured past 32^3, so the
      tile path keeps large meshes).

    ``alpha`` scalar or [B]; ``cells`` [3, 3] shared or [B, 3, 3].
    Returns per-atom energies [B, n] (self/background corrected), plus
    forces [B, n, 3] with ``compute_forces`` and/or per-atom
    ``d(sum E)/dq`` [B, n] with ``compute_charge_gradients`` (same
    return patterns as :func:`pme_reciprocal_space`).
    """
    from nvalchemiops_tpu import spline_windowed as sw

    _check_mesh_engines(spread_engine, gather_engine)
    if tile is None:
        # small per-system meshes: 16-point tiles shrink the per-tile W^2
        # expansion intermediates ~70x and fatten the matmuls.  Only when
        # the caller did not pass a tile_capacity (capacities are
        # tile-specific).
        ntiles8 = math.prod(int(d) // 8 for d in mesh_dimensions)
        if (tile_capacity is None and ntiles8 <= 512
                and all(int(d) % 16 == 0 for d in mesh_dimensions)):
            tile = 16
        else:
            tile = 8
    if not sw.windowed_applicable(mesh_dimensions, spline_order, tile=tile):
        raise ValueError(
            f"mesh {mesh_dimensions} / order {spline_order} not supported "
            "by the windowed path; use pme_reciprocal_space(batch_idx=...)")
    b, n = positions.shape[0], positions.shape[1]
    dtype = positions.dtype
    cells = jnp.asarray(cells, dtype)
    if cells.ndim == 2:
        cells = jnp.broadcast_to(cells[None], (b, 3, 3))
    alphas = jnp.broadcast_to(jnp.asarray(alpha, dtype).reshape(-1), (b,))
    if fft_mode == "auto":
        npts = math.prod(int(d) for d in mesh_dimensions)
        fft_mode = "matmul" if npts <= 32 * 32 * 32 else "xla"
    if engine == "auto":
        npts = math.prod(int(d) for d in mesh_dimensions)
        engine = "dense" if npts <= 32 * 32 * 32 else "windowed"
    if engine == "dense":
        energies, forces, charge_grads = _batch_dense_pme_impl(
            positions, jnp.asarray(charges, dtype), cells, alphas,
            tuple(int(d) for d in mesh_dimensions), int(spline_order),
            bool(compute_forces), fft_mode=fft_mode,
            compute_charge_gradients=bool(compute_charge_gradients))
    else:
        if tile_capacity is None:
            tile_capacity = sw.mesh_tile_capacity(n, mesh_dimensions,
                                                  tile=tile)
        energies, forces, charge_grads = _batch_windowed_pme_impl(
            positions, jnp.asarray(charges, dtype), cells, alphas,
            tuple(int(d) for d in mesh_dimensions), int(spline_order),
            int(tile_capacity), bool(compute_forces), fft_mode=fft_mode,
            compute_charge_gradients=bool(compute_charge_gradients),
            tile=int(tile))
    if compute_forces and compute_charge_gradients:
        return energies, forces, charge_grads
    if compute_forces:
        return energies, forces
    if compute_charge_gradients:
        return energies, charge_grads
    return energies


def grid_particle_mesh_ewald(grid, positions, charges, cell, cutoff,
                             alpha=None, mesh_dimensions=None,
                             spline_order: int = 4, accuracy: float = 1e-6,
                             tile_capacity: int | None = None,
                             fft_mode: str = "xla"):
    """Full PME at scale: halo-grid real space + tile-windowed reciprocal.

    The at-scale composition of :func:`particle_mesh_ewald` (reference:
    pme.py:1673-1994): the erfc-damped real-space sum runs on the
    gather-free halo grid (``grid.grid_coulomb_energy_forces``) instead of
    a padded neighbor matrix, and the reciprocal space through the
    tile-windowed spread/gather.  ``grid`` must have been built from
    ``positions`` with a build radius >= ``cutoff``.

    ``alpha`` defaults to ``sqrt(-ln(accuracy)) / cutoff`` (real-space
    error ~ ``accuracy`` at the fixed grid cutoff — the cutoff is set by
    the grid build here, unlike the Kolafa-Perram estimate which picks
    both).  Returns per-atom ``(energies, forces)`` (self- and
    background-corrected; forces always computed — the grid real-space
    kernel produces them at no extra pass).
    """
    dtype = positions.dtype
    cell_b = jnp.asarray(cell, dtype=dtype).reshape(-1, 3, 3)
    if alpha is None:
        alpha = math.sqrt(-math.log(accuracy)) / float(cutoff)
    alpha_f = float(jnp.asarray(alpha).reshape(()))
    if mesh_dimensions is None:
        mesh_dimensions = estimate_pme_mesh_dimensions(
            cell_b, jnp.asarray([alpha_f], dtype), accuracy)

    from nvalchemiops_tpu.grid import grid_coulomb_energy_forces

    e_real, f_real = grid_coulomb_energy_forces(
        grid, charges, float(cutoff), alpha_f)
    e_rec, f_rec = pme_reciprocal_space(
        positions, charges, cell_b, alpha_f,
        mesh_dimensions=mesh_dimensions, spline_order=spline_order,
        compute_forces=True, tile_capacity=tile_capacity,
        fft_mode=fft_mode)
    return e_real + e_rec, f_real + f_rec
