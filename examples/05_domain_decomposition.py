# SPDX-License-Identifier: Apache-2.0
"""Spatial domain decomposition: the grid sweep sharded over a device mesh.

The cell grid's z axis is split into slabs, one per device; inter-slab
pair interactions ride a ring of ``ppermute`` halo exchanges
(see ``nvalchemiops_tpu/parallel/domain.py``).  Runs on any JAX device
set — here we force an 8-device virtual CPU mesh so the example works
everywhere:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python \\
        examples/05_domain_decomposition.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.grid import (
    build_atom_grid,
    estimate_grid_geometry,
    grid_coulomb_energy_forces,
)
from nvalchemiops_tpu.parallel.domain import (
    domain_coulomb_energy_forces,
    domain_dftd3,
    make_z_mesh,
)

# --- a periodic box whose cell grid splits across the devices -----------
rng = np.random.default_rng(0)
n, box, cutoff = 2000, 32.0, 4.0
pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float32)
cell = jnp.asarray(np.eye(3) * box, jnp.float32)
pbc = np.array([True] * 3)

dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff, n,
                                           target_occupancy=0.5)
grid = build_atom_grid(pos, cell, pbc, dims, radius, cap)
mesh = make_z_mesh()
print(f"{len(jax.devices())} devices; grid dims {dims} -> "
      f"{dims[0] // mesh.devices.size}-cell z-slabs per device")

# --- damped Coulomb, sharded vs single-device ---------------------------
q = jnp.asarray(rng.normal(size=n), jnp.float32)
q = q - q.mean()
e_s, f_s = domain_coulomb_energy_forces(mesh, grid, q, cell, cutoff, 0.35)
e_1, f_1 = grid_coulomb_energy_forces(grid, q, cutoff, 0.35)
print(f"Coulomb: sharded E = {float(jnp.sum(e_s)):.6f}, "
      f"single-device E = {float(jnp.sum(e_1)):.6f}, "
      f"|dF|max = {float(jnp.max(jnp.abs(f_s - f_1))):.2e}")

# --- DFT-D3 with toy element tables, sharded ----------------------------
zmax = 4
numbers = jnp.asarray(rng.integers(1, zmax + 1, n), jnp.int32)
rcov = jnp.asarray(np.r_[0.0, rng.uniform(0.6, 1.4, zmax)], jnp.float32)
r4r2 = jnp.asarray(np.r_[0.0, rng.uniform(2.0, 6.0, zmax)], jnp.float32)
cna = jnp.asarray(
    np.vstack([np.zeros(5), np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)]),
    jnp.float32)
c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
c6[0] = 0.0
c6[:, 0] = 0.0
c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))

e_d3, f_d3, cn = domain_dftd3(mesh, grid, numbers, rcov, r4r2,
                              jnp.asarray(c6, jnp.float32), cna,
                              cutoff, 0.42, 4.1, 1.7, cell)
print(f"D3: sharded E = {float(e_d3):.6f}, mean CN = {float(cn.mean()):.3f}, "
      f"net force = {np.abs(np.asarray(f_d3).sum(0)).max():.2e}")

# --- fused: the whole real-space force field in ONE shard_map program ---
from nvalchemiops_tpu.parallel import domain_dftd3_coulomb

e_d3f, f_d3f, cnf, e_cf, f_cf = domain_dftd3_coulomb(
    mesh, grid, numbers, q, rcov, r4r2, jnp.asarray(c6, jnp.float32), cna,
    cutoff, 0.42, 4.1, 1.7, cell, alpha=0.35)
print(f"fused D3+Coulomb: E_d3 = {float(e_d3f):.6f} "
      f"(matches {float(e_d3):.6f}), E_c = {float(jnp.sum(e_cf)):.6f} "
      f"(matches {float(jnp.sum(e_s)):.6f}) — one halo-exchange set")
