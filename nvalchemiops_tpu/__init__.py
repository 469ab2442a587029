# SPDX-License-Identifier: Apache-2.0
"""nvalchemiops_tpu — JAX kernel library for atomistic simulation.

A from-scratch JAX rebuild of the capabilities of NVIDIA's
``nvalchemi-toolkit-ops`` (v0.2.0):

- Batched neighbor-list construction (brute-force O(N^2) and cell-list O(N),
  single and dual cutoff, single-system and batched) emitting fixed-capacity
  padded neighbor matrices — static shapes that map directly onto XLA.
- DFT-D3(BJ) dispersion energies, analytical forces and virials.
- Electrostatics: direct/damped Coulomb, classical Ewald summation, and
  FFT-based Particle Mesh Ewald with B-spline spread/gather.
- Supporting B-spline mesh interpolation, spherical harmonics, and GTO math.

Where the reference implements NVIDIA Warp kernels bridged to torch.autograd,
this library implements vectorized XLA formulations behind jit-friendly
functional APIs, with ``jax.custom_vjp`` providing the
energy -> force differentiation contract.

The scatter/atomics-heavy patterns of the CUDA original are re-architected as
gather + top_k compaction (neighbor packing), sort + binary-search binning
(cell lists), and dense matmul formulations (Ewald reciprocal space); the
reference's gather/neighbor-matrix formulations are kept beside them.
"""

__version__ = "0.2.0"

from nvalchemiops_tpu import (  # noqa: F401,E402
    grid,
    interactions,
    mathops,
    neighborlist,
    parallel,
    spline,
    spline_windowed,
)

__all__ = [
    "__version__",
    "grid",
    "interactions",
    "mathops",
    "neighborlist",
    "parallel",
    "spline",
    "spline_windowed",
]
