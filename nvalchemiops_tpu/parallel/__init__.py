# SPDX-License-Identifier: Apache-2.0
"""Multi-device scaling layer (an extension beyond the single-GPU reference).

The reference library is single-process / single-GPU (SURVEY.md §2.8: no
distributed runtime anywhere in the tree).  Here the scale-out is SPMD over
a ``jax.sharding.Mesh``: batched systems shard over a data axis ("dp") and
atoms within systems over a model axis ("sp"), with XLA inserting the
psum/all-gather collectives.  This package provides:

- :mod:`~nvalchemiops_tpu.parallel.mlip` — a differentiable machine-learned
  interatomic potential (learnable electrostatics + Born-Mayer repulsion +
  DFT-D3-style dispersion) whose forward/training steps exercise the whole
  library, on one device or sharded.
- :func:`make_mesh` / sharding helpers.
"""

from nvalchemiops_tpu.parallel.mlip import (  # noqa: F401
    D3Tables,
    MLIPParams,
    batched_energy_forces,
    default_d3_tables,
    init_mlip_params,
    make_mesh,
    mlip_energy,
    shard_batch,
    sharded_train_step,
    train_step,
)
from nvalchemiops_tpu.parallel.domain import (  # noqa: F401
    domain_coulomb_energy_forces,
    domain_dftd3,
    domain_dftd3_cn,
    domain_dftd3_coulomb,
    domain_pme_reciprocal,
    make_z_mesh,
)
from nvalchemiops_tpu.parallel.batch_pme import (  # noqa: F401
    sharded_batch_pme_reciprocal,
)

__all__ = [
    "MLIPParams",
    "batched_energy_forces",
    "sharded_batch_pme_reciprocal",
    "domain_coulomb_energy_forces",
    "domain_dftd3",
    "domain_dftd3_cn",
    "domain_dftd3_coulomb",
    "domain_pme_reciprocal",
    "init_mlip_params",
    "make_mesh",
    "make_z_mesh",
    "mlip_energy",
    "shard_batch",
    "sharded_train_step",
    "train_step",
]
