# SPDX-License-Identifier: Apache-2.0
"""Every engine selector rejects names it does not implement.

The library runs each job on plain XLA; an engine name that is not one
of a selector's own (including the names of kernels this library no
longer ships) must raise ``ValueError`` instead of falling back.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvalchemiops_tpu.grid import (
    build_atom_grid,
    estimate_grid_geometry,
    grid_coulomb_energy_forces,
)
from nvalchemiops_tpu.interactions.dispersion.dense_d3 import (
    batch_dense_dftd3,
    dense_dftd3,
)
from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
    grid_dftd3,
    grid_dftd3_coulomb,
)
from nvalchemiops_tpu.interactions.electrostatics.pme import (
    batch_pme_reciprocal,
    pme_reciprocal_space,
)
from nvalchemiops_tpu.stencil import (
    build_stencil_auto,
    stencil_cn_chain_forces,
    stencil_coordination_numbers,
    stencil_coulomb_energy_forces,
)


def _system(n_rep=4, a=2.0, seed=0):
    # a jittered simple-cubic crystal: the stencil needs one atom per voxel
    rng = np.random.default_rng(seed)
    lattice = np.stack(np.meshgrid(*[np.arange(n_rep) * a] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    n, box = lattice.shape[0], n_rep * a
    pos = jnp.asarray(lattice + rng.uniform(-0.05, 0.05, lattice.shape),
                      jnp.float32)
    cell = jnp.asarray(np.eye(3) * box, jnp.float32)
    q = jnp.asarray(rng.normal(size=n), jnp.float32)
    numbers = jnp.asarray(rng.integers(1, 3, n), jnp.int32)
    zmax = 2
    tables = dict(
        rcov=jnp.asarray(np.r_[0.0, rng.uniform(0.6, 1.4, zmax)], jnp.float32),
        r4r2=jnp.asarray(np.r_[0.0, rng.uniform(2.0, 6.0, zmax)], jnp.float32),
        c6=jnp.ones((zmax + 1, zmax + 1, 5, 5), jnp.float32),
        cna=jnp.asarray(np.tile(np.arange(5.0), (zmax + 1, 1)), jnp.float32),
    )
    return pos, cell, q, numbers, tables


def _grid(pos, cell, cutoff=3.0):
    pbc = np.array([True] * 3)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff,
                                               pos.shape[0],
                                               target_occupancy=0.4)
    return build_atom_grid(pos, cell, pbc, dims, radius, cap)


def _call(selector, name):
    pos, cell, q, numbers, t = _system()
    d3 = (t["rcov"], t["r4r2"], t["c6"], t["cna"])
    if selector == "grid_dftd3":
        grid_dftd3(_grid(pos, cell), numbers, *d3, 3.0, 0.4, 4.0, 1.7,
                   engine=name)
    elif selector == "grid_dftd3_coulomb":
        grid_dftd3_coulomb(_grid(pos, cell), numbers, q, *d3, 3.0, 0.4,
                           4.0, 1.7, engine=name)
    elif selector == "grid_coulomb":
        grid_coulomb_energy_forces(_grid(pos, cell), q, 3.0, 0.3,
                                   engine=name)
    elif selector == "dense_dftd3":
        dense_dftd3(pos, numbers, cell, 3.0, *d3, 0.4, 4.0, 1.7,
                    engine=name)
    elif selector == "batch_dense_dftd3":
        batch_dense_dftd3(pos[None], numbers[None], cell, 3.0, *d3, 0.4,
                          4.0, 1.7, engine=name)
    elif selector in ("pme_spread", "pme_gather"):
        key = "spread_engine" if selector == "pme_spread" else "gather_engine"
        pme_reciprocal_space(pos, q, cell, 0.5, mesh_dimensions=(8, 8, 8),
                             compute_forces=True, **{key: name})
    elif selector == "batch_pme_spread":
        batch_pme_reciprocal(pos[None], q[None], cell, 0.5, (8, 8, 8),
                             spread_engine=name)
    elif selector.startswith("stencil"):
        sg = build_stencil_auto(pos, cell, np.array([True] * 3), 3.0)
        if selector == "stencil_coulomb":
            stencil_coulomb_energy_forces(sg, q, 3.0, 0.3, engine=name)
        elif selector == "stencil_cn":
            stencil_coordination_numbers(sg, t["rcov"][numbers], 3.0,
                                         engine=name)
        else:
            stencil_cn_chain_forces(sg, t["rcov"][numbers], q, 3.0,
                                    engine=name)
    else:  # pragma: no cover - guards the parameter list below
        raise AssertionError(selector)


@pytest.mark.parametrize("selector,name", [
    ("grid_dftd3", "window"),
    ("grid_dftd3", "block"),
    ("grid_dftd3", "pallas"),
    ("grid_dftd3_coulomb", "window"),
    ("grid_dftd3_coulomb", "block"),
    ("grid_coulomb", "window"),
    ("grid_coulomb", "block"),
    ("dense_dftd3", "pallas"),
    ("batch_dense_dftd3", "pallas"),
    ("pme_spread", "pallas"),
    ("pme_gather", "pallas"),
    ("batch_pme_spread", "pallas"),
    ("stencil_coulomb", "pallas"),
    ("stencil_cn", "pallas"),
    ("stencil_chain", "pallas"),
])
def test_unknown_engine_raises(selector, name):
    with pytest.raises(ValueError, match="engine"):
        _call(selector, name)
