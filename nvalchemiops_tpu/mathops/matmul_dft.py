# SPDX-License-Identifier: Apache-2.0
"""Separable 3-D real-FFT convolution as dense matmuls (small-mesh path).

PME's reciprocal space is ``irfftn(rfftn(mesh) * kernel)`` with a *real*
kernel (Green's function x B-spline deconvolution, pme.py).  A DFT along
one axis is a matmul by the [n, n] transform matrix; for PME meshes
(n <= 128) the full O(n^2)-per-axis contraction is a few tens of GFLOPs,
which can beat a generic FFT's dispatch/layout overhead at small batched
sizes (the 64 x 32^3 batched-PME regime).  Everything stays in real planes
(structure-of-arrays re/im): no complex tensors materialize anywhere.

Matmuls run ``precision=HIGHEST`` — phase accuracy is geometry accuracy.

Normalization matches the library's PME convention: unscaled forward
(``rfftn(norm="backward")``) and unscaled inverse
(``irfftn(norm="forward")``); any volume factor lives in the kernel.

Reference counterpart: none (the reference calls cuFFT, pme.py:1398).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["matmul_rfft_convolve"]

_HIGH = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """Full-axis DFT matrices: cos[j,k], -sin[j,k] for exp(-2pi i jk/n)."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ang = 2.0 * np.pi * j * k / n
    return np.cos(ang), -np.sin(ang)


@lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Real-input z-axis matrices, forward [n, nh] and inverse [nh, n].

    Forward: F_k = sum_j m_j e^{-2pi i jk/n}, k = 0..n//2.
    Inverse (hermitian-weighted, real output, unscaled):
    m_j = sum_k w_k [Re(F_k) cos(2pi jk/n) - Im(F_k) sin(2pi jk/n)],
    w_k = 1 for k=0 and (n even) k=n/2, else 2.
    """
    nh = n // 2 + 1
    j, k = np.meshgrid(np.arange(n), np.arange(nh), indexing="ij")
    ang = 2.0 * np.pi * j * k / n
    fwd_c, fwd_s = np.cos(ang), -np.sin(ang)           # [n, nh]
    w = np.full(nh, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    inv_c = w[:, None] * np.cos(ang.T)                 # [nh, n]
    inv_s = -(w[:, None] * np.sin(ang.T))
    return fwd_c, fwd_s, inv_c, inv_s


def _mm(x, m, dtype):
    """Contract the last axis of x with matrix m (HIGHEST precision)."""
    return jnp.matmul(x, jnp.asarray(m, dtype), precision=_HIGH)


def _cyc(x):
    """Cycle the last three axes: (.., a, b, c) -> (.., b, c, a)."""
    nd = x.ndim
    perm = tuple(range(nd - 3)) + (nd - 2, nd - 1, nd - 3)
    return jnp.transpose(x, perm)


@partial(jax.jit, static_argnames=())
def matmul_rfft_convolve(mesh, kernel):
    """``irfftn(rfftn(mesh, norm="backward") * kernel, norm="forward")``
    over the last three axes, with a real ``kernel`` of shape
    ``mesh.shape[-3:-1] + (n_last//2 + 1,)``, as pure matmuls.

    ``mesh`` may carry arbitrary leading batch axes.  Output is real,
    same shape and dtype as ``mesh``.
    """
    dtype = mesh.dtype
    nx, ny, nz = mesh.shape[-3:]
    nzh = nz // 2 + 1
    if kernel.shape[-3:] != (nx, ny, nzh):
        raise ValueError(
            f"kernel shape {kernel.shape[-3:]} != rfft spectrum shape "
            f"{(nx, ny, nzh)}")

    fz_c, fz_s, iz_c, iz_s = _rdft_mats(nz)
    cy, sy = _dft_mats(ny)
    cx, sx = _dft_mats(nx)

    def cmul(re, im, c, s, conj=False):
        # complex matmul by (c + i s) — or its conjugate — on the last axis
        if conj:
            return (_mm(re, c.T, dtype) + _mm(im, s.T, dtype),
                    _mm(im, c.T, dtype) - _mm(re, s.T, dtype))
        return (_mm(re, c, dtype) - _mm(im, s, dtype),
                _mm(re, s, dtype) + _mm(im, c, dtype))

    # forward.  Layout walk (last three axes):
    # (x, y, z) --mm z--> (x, y, kz) --cyc,cyc--> (kz, x, y)
    # --mm y--> (kz, x, ky) --cyc,cyc--> (ky, kz, x) --mm x--> (ky, kz, kx)
    re = _mm(mesh, fz_c, dtype)
    im = _mm(mesh, fz_s, dtype)
    re, im = _cyc(_cyc(re)), _cyc(_cyc(im))      # (kz, x, y)
    re, im = cmul(re, im, cy, sy)                # (kz, x, ky)
    re, im = _cyc(_cyc(re)), _cyc(_cyc(im))      # (ky, kz, x)
    re, im = cmul(re, im, cx, sx)                # (ky, kz, kx)

    # kernel arrives as (kx, ky, kz) -> permute to (ky, kz, kx)
    kern = jnp.moveaxis(jnp.asarray(kernel, dtype), -3, -1)
    re = re * kern
    im = im * kern

    # inverse.  (ky, kz, kx) --conj mm x--> (ky, kz, x) --cyc--> (kz, x, ky)
    # --conj mm y--> (kz, x, y) --cyc--> (x, y, kz) --hermitian mm z--> (x, y, z)
    re, im = cmul(re, im, cx, sx, conj=True)     # (ky, kz, x)
    re, im = _cyc(re), _cyc(im)                  # (kz, x, ky)
    re, im = cmul(re, im, cy, sy, conj=True)     # (kz, x, y)
    re, im = _cyc(re), _cyc(im)                  # (x, y, kz)
    return _mm(re, iz_c, dtype) + _mm(im, iz_s, dtype)
