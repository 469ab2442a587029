# SPDX-License-Identifier: Apache-2.0
"""Dense minimum-image DFT-D3(BJ): the small-system batched path.

The halo-grid engine (grid_d3.py) is built for one large system; for the
reference's batched benchmark shape (128 x 2000-atom boxes,
dispersion/dftd3.py batch path) a 27-cell grid carries ~15x capacity slack
per candidate.  Small periodic boxes instead want the O(n^2) dense
formulation: minimum-image displacements [n, n], full [n, n] pair blocks
with zero padding slack, and the C6 interpolation as two [n, zm] x [zm, n]
matmuls — vmappable over the batch axis, and valid whenever
cutoff <= box/2 (the minimum-image bound; a two-image sweep extends it to
cutoff < box).

Same math and factor conventions as the matrix-path kernels
(_kernels.py): full-space pair enumeration, energy x 1/2, dE/dCN and
forces unhalved.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.mathops.math import apply_mat3
from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
    _d3_atom_features,
    element_c6_mask,
)

__all__ = ["dense_dftd3", "batch_dense_dftd3", "batch_dftd3"]


def _image_combos(images: bool, cell_np=None, cutoff: float | None = None):
    """Static (second-image bit per axis) combo list, distance-pruned.

    A combo whose bit set S puts the second image on every axis in S has
    pair distance at least

    - orthogonal cells:  r^2 >= sum_{a in S} (w_a / 2)^2  (axes independent)
    - general cells:     r   >= max_{a in S}  w_a / 2     (per-axis normal
      component alone)

    because the second-image fractional offset satisfies |d1| = 1 - |d0|
    >= 1/2.  Combos whose bound exceeds the cutoff can never contribute
    and are dropped at trace time — e.g. the reference's batched config
    (cutoff 21.2 A, 41.2 A boxes) keeps only the 4 single-axis combos out
    of 8.  With no concrete cell (traced), all 8 are kept (still correct).
    """
    if not images:
        return [(0, 0, 0)]
    combos = [(bx, by, bz)
              for bx in (0, 1) for by in (0, 1) for bz in (0, 1)]
    if cell_np is None or cutoff is None:
        return combos
    cell_np = np.asarray(cell_np, dtype=np.float64).reshape(3, 3)
    vol = abs(np.linalg.det(cell_np))
    widths = np.array([
        vol / np.linalg.norm(np.cross(cell_np[j], cell_np[k]))
        for j, k in ((1, 2), (2, 0), (0, 1))
    ])
    off = cell_np @ cell_np.T - np.diag(np.sum(cell_np * cell_np, axis=1))
    orthogonal = np.all(np.abs(off) < 1e-9 * np.max(np.abs(cell_np)) ** 2)
    kept = []
    for bits in combos:
        sel = (widths * 0.5)[np.array(bits, dtype=bool)]
        if sel.size == 0:
            kept.append(bits)
            continue
        bound = np.sqrt(np.sum(sel ** 2)) if orthogonal else np.max(sel)
        if bound < float(cutoff):
            kept.append(bits)
    return kept


def element_rows(numbers, table):
    """``table[numbers]`` without the conservative random-gather lowering.

    Per-atom element-table rows ([N] int32 x [Z, ...] -> [N, ...]) via an
    exact one-hot contraction instead of XLA's general gather.  The
    one-hot operand is exact at any precision and the contraction runs
    at HIGHEST, so the selection is bit-exact f32.  The choice was tuned
    on an earlier accelerator; the plain gather is to be measured
    against it on the GPU.
    """
    z = table.shape[0]
    flat = jnp.reshape(table, (z, -1))
    onehot = (numbers[..., None]
              == jnp.arange(z, dtype=numbers.dtype)).astype(flat.dtype)
    rows = jax.lax.dot_general(
        onehot.reshape(-1, z), flat, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=flat.dtype)
    return rows.reshape(numbers.shape + table.shape[1:])


def _dense_impl(positions, numbers, cell, cutoff, rcov, r4r2, cna_a, mask_a,
                c6p_a, a1, a2, s6, s8, k1, k3, images: bool = False,
                combos=None):
    dtype = positions.dtype
    n = positions.shape[0]
    alive_f = (numbers != 0).astype(dtype)

    # images=True additionally visits the second-nearest image per axis
    # (d1 = d0 - sign(d0)): the (nearest|second)^3 combos cover every
    # image within one box length, extending validity from
    # cutoff <= width/2 to cutoff < width (the reference's 21.2 A batched
    # CsCl boxes are ~41 A, so minimum image alone misses shell pairs).
    # Per-pair quantities (C6 interpolation, dE/dCN weights) are computed
    # once; only the radial factors run per image combo.
    #
    # Memory discipline (the bottleneck is memory traffic, not flops): every
    # per-combo [n, n] plane — fractional diffs, distances, masks, vdW
    # radii polynomials — is expressed as a fused elementwise DAG over
    # [n] vectors with an immediate row reduction, so nothing but the two
    # C6 matmul products ever round-trips HBM per combo.  The image sum
    # for energy/dE_dCN is accumulated per combo (scalars / [n] rows),
    # NOT as a [n, n] acc_damp plane: at 128 x 2000 the plane accumulator
    # alone would move ~8 GB per image combo.
    inv_cell = jnp.linalg.inv(cell)
    frac = apply_mat3(positions, inv_cell)  # exact f32 (no matmul)
    fcols = [frac[:, c] for c in range(3)]
    if combos is None:
        combos = _image_combos(images)

    def cart(bits):
        ds = []
        for c in range(3):
            dc = fcols[c][None, :] - fcols[c][:, None]
            d0 = dc - jnp.round(dc)
            if bits[c]:
                # only the NEAR second image can fall inside cutoff <
                # width (the far one sits at |d0| + 1 >= 1 box); for
                # d0 == 0 both second images are one width away: excluded
                d0 = d0 - jnp.where(d0 >= 0, 1.0, -1.0)
            ds.append(d0)
        dx = ds[0] * cell[0, 0] + ds[1] * cell[1, 0] + ds[2] * cell[2, 0]
        dy = ds[0] * cell[0, 1] + ds[1] * cell[1, 1] + ds[2] * cell[2, 1]
        dz = ds[0] * cell[0, 2] + ds[1] * cell[1, 2] + ds[2] * cell[2, 2]
        return dx, dy, dz

    cut2 = cutoff * cutoff
    rcov_a = rcov.astype(dtype)[numbers] * alive_f  # dead rows -> rc = 0

    # ---- pass 1: coordination numbers (image-summed) ----------------------
    cn = jnp.zeros((n,), dtype)
    for bits in combos:
        dx, dy, dz = cart(bits)
        r2 = dx * dx + dy * dy + dz * dz
        ok = (r2 < cut2) & (r2 > 1e-20)
        inv_r = jax.lax.rsqrt(jnp.where(ok, r2, 1.0))
        rc = rcov_a[:, None] + rcov_a[None, :]
        f_cn = jnp.where(
            ok, 1.0 / (1.0 + jnp.exp(-k1 * (rc * inv_r - 1.0))), 0.0)
        # rc == 0 pairs (either end padding) give f_cn = sigmoid(-k1) ~
        # 1e-7 spread over <= n slots — mask via the alive row product
        cn = cn + jnp.sum(f_cn * alive_f[None, :], axis=1) * alive_f

    # ---- per-atom features (COMPENSATED l1c/rfdc derivative features:
    # z_di = z_di_naive - c6 w_di comes straight out of the dot — the
    # naive difference cancels catastrophically for atoms whose CN sits
    # far from every reference point; see _d3_atom_features) -------------
    l0, l1c, rf, rfdc, w_a, wd_a = _d3_atom_features(
        numbers, cn, cna_a, mask_a, c6p_a, k3, dtype)

    # ---- pass 2: energy, direct forces, dE/dCN ---------------------------
    # HIGHEST is ~free here: the [n, zm] x [zm, n] dots are small next
    # to the n^2 elementwise pair math
    hi = jax.lax.Precision.HIGHEST
    zacc = jnp.matmul(l0, rf.T, precision=hi)
    z_di = jnp.matmul(l1c, rf.T, precision=hi)
    # no z_dj dot: the dense sweep sees every pair from both sides, so the
    # j-side dE/dCN term is i's z_di when the roles swap
    w = w_a[:, None] * w_a[None, :]

    good = (w > 1e-12) & (alive_f[:, None] * alive_f[None, :] > 0.0)
    w_inv = 1.0 / jnp.where(good, w, 1.0)
    c6_raw = jnp.where(good, zacc * w_inv, 0.0)
    # masked planes: c6m carries the pair mask (c6 >= 1e-12 covers
    # padding, since dead rows have w_a = mask-sum = 0 -> good = False);
    # zdw folds mask, w_inv and the -2 k3 constant so each image combo
    # reads exactly these two planes from HBM
    c6m = jnp.where(c6_raw >= 1e-12, c6_raw, 0.0)
    zdw = jnp.where(c6_raw >= 1e-12, (-2.0 * k3) * w_inv * z_di, 0.0)

    si = jnp.sqrt(r4r2.astype(dtype) * 1.7320508075688772)[numbers]

    energy = jnp.zeros((), dtype)
    de_dcn = jnp.zeros((n,), dtype)
    fx = jnp.zeros((n,), dtype)
    fy = jnp.zeros((n,), dtype)
    fz = jnp.zeros((n,), dtype)
    for bits in combos:
        dx, dy, dz = cart(bits)
        r2 = dx * dx + dy * dy + dz * dz
        ok = (r2 < cut2) & (r2 > 1e-20)
        r2_safe = jnp.where(ok, r2, 1.0)
        r4 = r2_safe * r2_safe
        r6 = r4 * r2_safe
        r8 = r4 * r4
        t = si[:, None] * si[None, :]
        rr = t * t
        r0 = a1 * t + a2
        r0_2 = r0 * r0
        r0_6 = r0_2 * r0_2 * r0_2
        r0_8 = r0_6 * r0_2
        den6 = r6 + r0_6
        den8 = r8 + r0_8
        rec = 1.0 / (den6 * den8)
        den6_inv = rec * den8
        den8_inv = rec * den6
        damp_sum = jnp.where(ok, s6 * den6_inv + s8 * rr * den8_inv, 0.0)
        energy = energy - 0.5 * jnp.sum(c6m * damp_sum)
        de_dcn = de_dcn + jnp.sum(damp_sum * zdw, axis=1)

        dd6 = -6.0 * s6 * r4 * den6_inv * den6_inv
        dd8 = -8.0 * s8 * rr * r6 * den8_inv * den8_inv
        coef = jnp.where(ok, -c6m * (dd6 + dd8), 0.0)
        fx = fx + jnp.sum(coef * dx, axis=1)
        fy = fy + jnp.sum(coef * dy, axis=1)
        fz = fz + jnp.sum(coef * dz, axis=1)

    # ---- pass 3: CN chain-rule forces (image-summed) -----------------------
    # dead rows have de_dcn = 0 AND dcn_dr masked by rc = 0 -> sigmoid'
    # tail ~1e-7 * de_pair; kill it exactly with the alive product
    de_i = de_dcn * alive_f
    for bits in combos:
        dx, dy, dz = cart(bits)
        r2 = dx * dx + dy * dy + dz * dz
        ok = (r2 < cut2) & (r2 > 1e-20)
        inv_r = jax.lax.rsqrt(jnp.where(ok, r2, 1.0))
        rc = rcov_a[:, None] + rcov_a[None, :]
        rrq = rc * inv_r
        f3 = 1.0 / (1.0 + jnp.exp(-k1 * (rrq - 1.0)))
        dcn_dr_r = -f3 * (1.0 - f3) * k1 * rrq * inv_r * inv_r
        de_pair = de_i[:, None] + de_i[None, :]
        alive_pair_f = alive_f[:, None] * alive_f[None, :]
        coef3 = jnp.where(ok, de_pair * dcn_dr_r * alive_pair_f, 0.0)
        fx = fx + jnp.sum(coef3 * dx, axis=1)
        fy = fy + jnp.sum(coef3 * dy, axis=1)
        fz = fz + jnp.sum(coef3 * dz, axis=1)

    forces = jnp.stack([fx, fy, fz], axis=-1)
    return energy, forces, cn


def min_perpendicular_width(cell) -> float:
    """Smallest perpendicular cell width (host-side, concrete cell).

    ``V / max_face_area`` — the minimum-image bound is ``cutoff <= w/2``;
    the two-candidate image sweep (``images=True``) is valid for
    ``cutoff < w``.
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(3, 3)
    vol = abs(np.linalg.det(cell_np))
    widths = [
        vol / np.linalg.norm(np.cross(cell_np[j], cell_np[k]))
        for j, k in ((1, 2), (2, 0), (0, 1))
    ]
    return float(min(widths))


def _resolve_images(images, cell, cutoff):
    """Auto-select the image mode from a concrete cell; validate bounds.

    Concreteness tests must NOT round-trip through ``jnp.asarray``: under
    a dynamic trace (e.g. a ``fori_loop`` body) that binds a convert
    primitive and turns plain Python scalars into tracers.
    """
    if images is not None:
        return bool(images)
    if isinstance(cell, jax.core.Tracer):
        raise ValueError(
            "dense_dftd3 under a jax trace needs an explicit images= flag "
            "(the minimum-image validity check reads concrete cell values)"
        )
    w = min_perpendicular_width(cell)
    cut = float(np.asarray(jax.device_get(cutoff)))
    if cut <= 0.5 * w:
        return False
    if cut < w:
        return True
    raise ValueError(
        f"dense D3 requires cutoff < min cell width ({cut} >= {w}); "
        "use the grid or neighbor-matrix paths"
    )


def _check_dense_engine(engine: str):
    """The dense path has one engine, the XLA pair planes."""
    if engine not in ("auto", "xla"):
        raise ValueError(
            f"unknown dense engine {engine!r}; expected 'auto' or 'xla'")


def dense_dftd3(positions, numbers, cell, cutoff, rcov, r4r2, c6ab,
                cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                images: bool | None = None, combos=None,
                engine: str = "auto"):
    """DFT-D3(BJ) via dense pair planes.

    Same physics contract as :func:`grid_d3.grid_dftd3`; ``numbers == 0``
    marks padding atoms.  Returns ``(energy, forces [n, 3], cn [n])``.

    ``images=None`` (default) picks minimum-image when
    ``cutoff <= width/2`` and the two-candidate-per-axis image sweep when
    ``width/2 < cutoff < width`` (e.g. the reference's 21.2 A batched
    benchmark on ~41 A CsCl boxes); pass the flag explicitly when ``cell``
    is traced (vmap/grad).

    ``engine``: ``"auto"`` (default) and ``"xla"`` both run the XLA pair
    planes; any other name raises ``ValueError``.
    """
    _check_dense_engine(engine)
    dtype = positions.dtype
    numbers = jnp.asarray(numbers, INDEX_DTYPE)
    images = _resolve_images(images, cell, cutoff)
    if combos is None:
        cell_concrete = not isinstance(cell, jax.core.Tracer)
        cut_concrete = not isinstance(cutoff, jax.core.Tracer)
        if images and cell_concrete and cut_concrete:
            combos = _image_combos(
                True, jax.device_get(cell), float(jax.device_get(cutoff)))
        else:
            combos = _image_combos(images)
    zmax1 = rcov.shape[0]
    mesh = cn_ref_elem.shape[1]
    mask_elem = element_c6_mask(c6ab)
    cna_a = element_rows(numbers, cn_ref_elem.astype(dtype))
    mask_a = element_rows(numbers, mask_elem.astype(dtype))
    c6p = jnp.transpose(c6ab.astype(dtype), (0, 2, 1, 3)).reshape(
        zmax1, mesh, zmax1 * mesh)
    c6p_a = element_rows(numbers, c6p)
    cell = jnp.asarray(cell, dtype).reshape(3, 3)
    return _dense_impl(
        positions, numbers, cell, jnp.asarray(cutoff, dtype),
        jnp.asarray(rcov), jnp.asarray(r4r2), cna_a, mask_a, c6p_a,
        jnp.asarray(a1, dtype), jnp.asarray(a2, dtype),
        jnp.asarray(s6, dtype), jnp.asarray(s8, dtype),
        jnp.asarray(k1, dtype), jnp.asarray(k3, dtype), images=images,
        combos=combos)


def batch_dense_dftd3(positions, numbers, cells, cutoff, rcov, r4r2, c6ab,
                      cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                      system_chunk: int | None = None,
                      images: bool | None = None, engine: str = "auto"):
    """Batched dense D3: vmap of :func:`dense_dftd3` over the system axis.

    ``positions`` [B, n, 3], ``numbers`` [B, n], ``cells`` [3, 3] shared
    or [B, 3, 3].  Returns ``(energy [B], forces [B, n, 3], cn [B, n])``.

    The live [n, n] pair planes cost ~6 n^2 floats per in-flight system
    (~9 with ``images``); ``system_chunk`` (default: sized so chunks stay
    under ~2 GB) runs the batch as ``lax.map`` over vmapped chunks so HBM
    stays bounded at any batch size.  Requires ``B % system_chunk == 0``.

    ``images`` is resolved on the host from the *worst-case* cell of the
    batch (cells are concrete here, pre-vmap) and applied uniformly.

    ``engine`` as in :func:`dense_dftd3`.
    """
    _check_dense_engine(engine)
    positions = jnp.asarray(positions)
    b, n = positions.shape[0], positions.shape[1]
    cells = jnp.asarray(cells, positions.dtype)
    shared = cells.ndim == 2
    combos = None
    if images is None:
        if shared:
            images = _resolve_images(None, cells, cutoff)
            if images:
                combos = _image_combos(
                    True, jax.device_get(cells),
                    float(np.asarray(jax.device_get(cutoff))))
        else:
            widths = [min_perpendicular_width(cells[i]) for i in range(b)]
            images = _resolve_images(
                None, np.eye(3) * min(widths), cutoff)
            if images:
                # conservative across the batch: a combo is dropped only
                # when every system's bound excludes it (union of combos)
                cut = float(np.asarray(jax.device_get(cutoff)))
                cells_np = jax.device_get(cells)
                union = set()
                for i in range(b):
                    union.update(_image_combos(True, cells_np[i], cut))
                combos = sorted(union)
    if system_chunk is None:
        planes = 9 if images else 6
        budget = int((2 << 30) / (planes * 4 * n * n))
        system_chunk = max(1, min(b, budget))
        while b % system_chunk:
            system_chunk -= 1
    if b % system_chunk:
        raise ValueError(f"B={b} must divide by system_chunk={system_chunk}")

    if shared:
        fn = lambda p, z: dense_dftd3(  # noqa: E731
            p, z, cells, cutoff, rcov, r4r2, c6ab, cn_ref_elem,
            a1, a2, s8, s6=s6, k1=k1, k3=k3, images=images, combos=combos,
            engine="xla")
        vfn = jax.vmap(fn)
        if system_chunk == b:
            return vfn(positions, numbers)
        out = jax.lax.map(
            lambda args: vfn(*args),
            (positions.reshape(b // system_chunk, system_chunk, n, 3),
             numbers.reshape(b // system_chunk, system_chunk, n)))
        return jax.tree.map(lambda a: a.reshape((b,) + a.shape[2:]), out)

    fn = lambda p, z, c: dense_dftd3(  # noqa: E731
        p, z, c, cutoff, rcov, r4r2, c6ab, cn_ref_elem,
        a1, a2, s8, s6=s6, k1=k1, k3=k3, images=images, combos=combos,
        engine="xla")
    vfn = jax.vmap(fn)
    if system_chunk == b:
        return vfn(positions, numbers, cells)
    out = jax.lax.map(
        lambda args: vfn(*args),
        (positions.reshape(b // system_chunk, system_chunk, n, 3),
         numbers.reshape(b // system_chunk, system_chunk, n),
         cells.reshape(b // system_chunk, system_chunk, 3, 3)))
    return jax.tree.map(lambda a: a.reshape((b,) + a.shape[2:]), out)


#: dense<->grid crossover for the unified batch router, atoms per system
#: at ~0.1 atoms/A^3 and a 9 A cutoff: the O(n^2) dense sweep wins for
#: small systems, the O(n) grid for large ones.  Tuned on an earlier
#: accelerator; to be measured again on the GPU with a cell on each side.
BATCH_DENSE_MAX_ATOMS = 8192


def batch_dftd3(positions, numbers, cells, pbc, cutoff, rcov, r4r2, c6ab,
                cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0, k3=-4.0,
                engine: str = "auto", **kwargs):
    """Unified batched DFT-D3(BJ): dense <-> grid routing.

    ``engine="auto"`` picks between the two batched engines the library
    ships:

    - **dense** (:func:`batch_dense_dftd3`): full [n, n] pair planes with
      min-image (+ distance-pruned second-image combos when cutoff >
      width/2).  Cost ~ B n^2 pair slots; no neighbor structure.  The only valid engine when the halo
      grid cannot represent the cutoff (search radius > cells per
      dimension, e.g. the matched 21.2 A config on 41 A boxes).  Assumes
      full PBC, so non-all-True ``pbc`` routes to the grid engine.
    - **grid** (:func:`~nvalchemiops_tpu.interactions.dispersion.grid_d3.
      batch_grid_dftd3`): fused whole-batch halo-grid build + vmapped
      row sweep.  Cost ~ B n x (swept slots/atom, typically
      3-4k at 9 A) + build.

    Routing rule: dense when every system has ``n <=
    BATCH_DENSE_MAX_ATOMS`` AND ``pbc`` is all-True, or when
    the grid geometry is infeasible for (cell, cutoff); grid otherwise.
    ``engine="dense"``/``engine="grid"`` force a path; remaining kwargs
    go to the chosen engine.
    """
    from nvalchemiops_tpu.grid import estimate_grid_geometry
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3,
    )

    positions = jnp.asarray(positions)
    n = positions.shape[1]
    cells = jnp.asarray(cells, positions.dtype)
    cell0 = cells if cells.ndim == 2 else cells[0]
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1)[:3]
    if engine == "auto":
        grid_ok = True
        try:
            estimate_grid_geometry(cell0, pbc_np, float(cutoff), n)
        except ValueError:
            grid_ok = False
        if not grid_ok or (pbc_np.all() and n <= BATCH_DENSE_MAX_ATOMS):
            engine = "dense"
        else:
            engine = "grid"
    if engine == "dense":
        if not pbc_np.all():
            raise ValueError(
                "batch dense D3 assumes full PBC; use engine='grid' for "
                f"mixed pbc {pbc_np.tolist()}")
        return batch_dense_dftd3(positions, numbers, cells, cutoff, rcov,
                                 r4r2, c6ab, cn_ref_elem, a1, a2, s8,
                                 s6=s6, k1=k1, k3=k3, **kwargs)
    if engine != "grid":
        raise ValueError(f"unknown engine {engine!r}")
    return batch_grid_dftd3(positions, numbers, cells, pbc_np, cutoff,
                            rcov, r4r2, c6ab, cn_ref_elem, a1, a2, s8,
                            s6=s6, k1=k1, k3=k3, **kwargs)
