# SPDX-License-Identifier: Apache-2.0
"""Dtype policy helpers.

The reference maps torch dtypes onto Warp scalar/vector/matrix types
(reference: nvalchemiops/types.py:20-53).  Here there is no separate kernel
type system — JAX arrays flow straight into XLA — so this module only
centralizes the dtype conventions used across the library:

- ``INDEX_DTYPE``: neighbor matrices, shift matrices, counters are int32.
- ``accumulator_dtype``: pairwise accumulations upcast to float32 (from
  float16/bfloat16) or stay in the input precision for float32/float64,
  mirroring the reference's register-precision policy (e.g. float64
  accumulators in the D3 kernels, dftd3.py:1052-1060).
"""

from __future__ import annotations

import jax.numpy as jnp

INDEX_DTYPE = jnp.int32

#: dtypes accepted for positions / cells across the library
SUPPORTED_FLOAT_DTYPES = (jnp.float16, jnp.bfloat16, jnp.float32, jnp.float64)


def canonical_float_dtype(dtype) -> jnp.dtype:
    """Validate and canonicalize a floating dtype for positions/cells."""
    dtype = jnp.dtype(dtype)
    if dtype not in [jnp.dtype(d) for d in SUPPORTED_FLOAT_DTYPES]:
        raise ValueError(
            f"Unsupported floating dtype {dtype}; expected one of "
            f"{[str(jnp.dtype(d)) for d in SUPPORTED_FLOAT_DTYPES]}"
        )
    return dtype


def accumulator_dtype(dtype) -> jnp.dtype:
    """Accumulation dtype for a given input dtype (>= float32)."""
    dtype = jnp.dtype(dtype)
    if dtype in (jnp.dtype(jnp.float16), jnp.dtype(jnp.bfloat16)):
        return jnp.dtype(jnp.float32)
    return dtype
