# SPDX-License-Identifier: Apache-2.0
"""A differentiable MLIP built from the library's interaction terms.

This is the flagship end-to-end workload (SURVEY.md §7, phase 9 — the
"MLIP step"): a physically-structured machine-learned interatomic potential

    E = E_elec (erfc-damped Coulomb, learnable per-element charges)
      + E_rep  (Born-Mayer exp repulsion, learnable amplitudes/length)
      + E_disp (DFT-D3(BJ)-style dispersion with CN-interpolated C6,
                learnable damping/scaling)

evaluated over periodic systems with full autodiff: forces are exact energy
gradients, and the training step differentiates through everything
(including coordination numbers and the C6 interpolation).

Multi-device: batched systems live in a padded [B, n, ...] layout; under a
``jax.sharding.Mesh`` with axes ``("dp", "sp")`` the batch shards over
``dp`` (data parallel over systems) and the atom axis over ``sp``
(intra-system parallelism).  The pairwise energies contract atoms against
atoms, so XLA's SPMD partitioner inserts the all-gather of the ``sp``-sharded
positions and the psum of energies/gradients, which XLA hands to the
device interconnect (NCCL on GPUs) — what a hand-coded design would
write out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.mathops.math import apply_mat3, erfc_approx
from nvalchemiops_tpu.interactions.dispersion.dftd3 import _c6_interpolate

__all__ = [
    "MLIPParams",
    "init_mlip_params",
    "mlip_energy",
    "batched_energy_forces",
    "train_step",
    "make_mesh",
    "shard_batch",
    "sharded_train_step",
]


class MLIPParams(NamedTuple):
    """Learnable parameters (element-indexed tables + scalars)."""

    charge: jax.Array  # [Zmax+1] per-element partial charges
    repulse_a: jax.Array  # [Zmax+1] Born-Mayer amplitudes (log-space)
    repulse_rho: jax.Array  # [] Born-Mayer decay length (log-space)
    s6: jax.Array  # [] dispersion scalings
    s8: jax.Array
    a1: jax.Array  # [] BJ damping
    a2: jax.Array


class D3Tables(NamedTuple):
    """Fixed element tables for the dispersion term."""

    rcov: jax.Array
    r4r2: jax.Array
    c6ab: jax.Array
    cn_ref: jax.Array


def init_mlip_params(zmax: int, dtype=jnp.float32) -> MLIPParams:
    """Smooth, non-degenerate starting parameters for the toy MLIP."""
    z = jnp.arange(zmax + 1, dtype=dtype)
    return MLIPParams(
        charge=0.1 * jnp.sin(z),
        repulse_a=jnp.full((zmax + 1,), 1.0, dtype=dtype),
        repulse_rho=jnp.asarray(-1.0, dtype=dtype),  # log(rho) ~ rho = 0.37
        s6=jnp.asarray(1.0, dtype=dtype),
        s8=jnp.asarray(1.5, dtype=dtype),
        a1=jnp.asarray(0.4, dtype=dtype),
        a2=jnp.asarray(4.0, dtype=dtype),
    )


def default_d3_tables(zmax: int, seed: int = 0, dtype=jnp.float32) -> D3Tables:
    """Smooth synthetic element tables (for demos/benchmarks)."""
    rng = np.random.default_rng(seed)
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cn = np.cumsum(rng.uniform(0.3, 1.0, (zmax + 1, zmax + 1, 5, 5)), axis=2)
    return D3Tables(
        rcov=jnp.asarray(rcov, dtype),
        r4r2=jnp.asarray(r4r2, dtype),
        c6ab=jnp.asarray(c6, dtype),
        cn_ref=jnp.asarray(cn, dtype),
    )


def _minimum_image_pairs(positions, cell):
    """All-pair displacement vectors under the minimum-image convention.

    [n, n, 3]; suitable for cutoffs below half the box (the MLIP's
    short-range terms).  Differentiable w.r.t. positions and cell.
    """
    frac = apply_mat3(positions, jnp.linalg.inv(cell))
    dfrac = frac[None, :, :] - frac[:, None, :]
    dfrac = dfrac - jnp.round(dfrac)
    return apply_mat3(dfrac, cell)


def mlip_energy(params: MLIPParams, tables: D3Tables, positions, numbers, cell,
                cutoff, alpha=0.6):
    """Total energy of one (padded) periodic system.

    ``numbers == 0`` marks padding atoms.  Dense minimum-image pair sum —
    the jit/SPMD-friendly formulation for systems up to a few thousand atoms
    per device; larger systems use the neighbor-matrix pipelines instead.
    """
    dtype = positions.dtype
    n = positions.shape[0]
    numbers = numbers.astype(INDEX_DTYPE)
    alive = numbers != 0

    d = _minimum_image_pairs(positions, cell)
    r2 = jnp.sum(d * d, axis=-1)
    eye = jnp.eye(n, dtype=bool)
    pair_ok = alive[:, None] & alive[None, :] & ~eye
    r2_safe = jnp.where(pair_ok, r2, 1.0)
    r = jnp.sqrt(r2_safe)
    cutoff_t = jnp.asarray(cutoff, dtype=dtype)
    mask = pair_ok & (r < cutoff_t) & (r > 1e-6)
    r = jnp.where(mask, r, 1.0)
    inv_r = 1.0 / r

    q = params.charge[numbers] * alive
    qq = q[:, None] * q[None, :]
    e_elec = 0.5 * jnp.sum(jnp.where(mask, qq * erfc_approx(alpha * r) * inv_r, 0.0))

    a_rep = jnp.exp(params.repulse_a)[numbers] * alive
    rho = jnp.exp(params.repulse_rho)
    e_rep = 0.5 * jnp.sum(
        jnp.where(mask, a_rep[:, None] * a_rep[None, :] * jnp.exp(-r / rho), 0.0)
    )

    # dispersion: CN -> C6(CN) -> BJ-damped -C6/r^6 - C8/r^8
    rcov_ij = tables.rcov[numbers][:, None] + tables.rcov[numbers][None, :]
    f_cn = 1.0 / (1.0 + jnp.exp(-16.0 * (rcov_ij * inv_r - 1.0)))
    cn = jnp.sum(jnp.where(mask, f_cn, 0.0), axis=1)

    zi = numbers[:, None]
    zj = numbers[None, :]
    c6_mat = tables.c6ab[zi, zj]
    cnref_i = tables.cn_ref[zi, zj]
    cnref_j = tables.cn_ref[zj, zi]
    c6, _, _ = _c6_interpolate(cn[:, None], cn[None, :], c6_mat, cnref_i, cnref_j, -4.0)

    rr = 3.0 * tables.r4r2[numbers][:, None] * tables.r4r2[numbers][None, :]
    r0 = params.a1 * jnp.sqrt(rr) + params.a2
    r6 = r2_safe**3
    r8 = r2_safe**4
    e_disp = 0.5 * jnp.sum(
        jnp.where(
            mask,
            -c6 * (params.s6 / (r6 + r0**6) + params.s8 * rr / (r8 + r0**8)),
            0.0,
        )
    )
    return e_elec + e_rep + e_disp


def batched_energy_forces(params, tables, positions, numbers, cell, cutoff):
    """[B, n, ...] batched energies and forces (forces = -dE/dr, exact)."""

    def total(p):
        e = jax.vmap(
            lambda pos, z, c: mlip_energy(params, tables, pos, z, c, cutoff)
        )(p, numbers, cell)
        return jnp.sum(e), e

    (etot, energies), grads = jax.value_and_grad(total, has_aux=True)(positions)
    return energies, -grads


def loss_fn(params, tables, batch, cutoff):
    """Energy + force MSE of the batched MLIP against batch targets."""
    positions, numbers, cell, target_e, target_f = batch
    energies, forces = batched_energy_forces(
        params, tables, positions, numbers, cell, cutoff
    )
    alive = (numbers != 0)[..., None]
    n_alive = jnp.maximum(jnp.sum(alive), 1)
    e_loss = jnp.mean((energies - target_e) ** 2)
    f_loss = jnp.sum(jnp.where(alive, (forces - target_f) ** 2, 0.0)) / n_alive
    return e_loss + f_loss


def train_step(params, tables, batch, cutoff, lr=1e-3):
    """One SGD step on the force-matching loss (fully differentiable)."""
    loss, grads = jax.value_and_grad(loss_fn)(params, tables, batch, cutoff)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None) -> Mesh:
    """Build a ("dp", "sp") mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None or sp is None:
        # widest sp that divides n, preferring sp >= dp
        sp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                sp = n // cand
                break
        dp = n // sp
    mesh_devices = np.asarray(devices).reshape(dp, sp)
    return Mesh(mesh_devices, ("dp", "sp"))


def shard_batch(mesh: Mesh, batch):
    """Place a (positions, numbers, cell, target_e, target_f) batch on the mesh.

    Systems shard over "dp", atoms over "sp"; per-system arrays shard over
    "dp" only.
    """
    positions, numbers, cell, target_e, target_f = batch
    s_atom = NamedSharding(mesh, P("dp", "sp"))
    s_sys = NamedSharding(mesh, P("dp"))
    return (
        jax.device_put(positions, NamedSharding(mesh, P("dp", "sp", None))),
        jax.device_put(numbers, s_atom),
        jax.device_put(cell, NamedSharding(mesh, P("dp", None, None))),
        jax.device_put(target_e, s_sys),
        jax.device_put(target_f, NamedSharding(mesh, P("dp", "sp", None))),
    )


def sharded_train_step(mesh: Mesh, cutoff: float, lr: float = 1e-3):
    """jit-compiled SPMD training step for a ("dp", "sp") mesh.

    Parameters stay replicated; batch arrays arrive sharded (see
    :func:`shard_batch`).  XLA partitions the pairwise contractions and
    inserts the collectives (all-gather of sp-sharded positions inside
    each system, psum of loss/grads across the mesh).
    """
    replicated = NamedSharding(mesh, P())

    @jax.jit
    def step(params, tables, batch):
        params = jax.lax.with_sharding_constraint(params, replicated)
        loss, grads = jax.value_and_grad(loss_fn)(params, tables, batch, cutoff)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        new_params = jax.lax.with_sharding_constraint(new_params, replicated)
        return new_params, loss

    return step
