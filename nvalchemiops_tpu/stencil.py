# SPDX-License-Identifier: Apache-2.0
"""Commensurate voxel-stencil pair sweep (occupancy-1 fine binning).

The row sweep (grid.py) pays two structural slacks on every pair pass:
``(cap/occupancy)^2`` capacity padding and the cube-vs-sphere candidate
volume of cutoff-sized bins.  For systems that admit a *commensurate fine
binning* — bins small enough that no two atoms share one (any near-
crystalline solid: one lattice site per voxel; checked at build time) —
this engine removes the capacity axis entirely:

- every field lives on one flat plane ``[Ez, Ey*Ex + 2*pad]`` (the (y, x)
  axes flattened with the halo *inline*, padded by ``pad = Ry*Ex + Rx``
  columns so any (dy, dx) cell offset is a single static column shift);
- the half-space sweep pairs the plane against ``(2R+1)^3 / 2`` shifted
  slices of itself — one candidate per slot, no ``[cap, W]`` blocks, no
  reductions;
- empty voxels are parked far away at build time (displacement validity,
  grid.py:DISPLACE) so the ``d^2 < cutoff^2`` test alone excludes them.

At 9 A cutoff with 3 A voxels the candidate slack drops from the row
sweep's ~7-12x to the ~3x cube-vs-sphere floor, so an op-count-bound
pair pass does proportionally less work.

The matmul-heavy D3 interpolation pass keeps the row layout (its bilinear
C6 matmuls need operand reuse across a candidate window, which the
one-candidate-per-slot stencil cannot feed); see
interactions/dispersion/grid_d3.py for the hybrid wiring.

Reference counterpart: none — the reference's cell list (cell_list.py)
covers this regime with cap >= 1 per-thread loops; the voxel formulation
removes the capacity padding that a dense per-cell layout pays.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.mathops.math import apply_mat3, erfc_approx
from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.grid import DISPLACE, DISPLACE_SPACING


@jax.tree_util.register_pytree_node_class
class StencilGrid:
    """Flat halo-inline voxel planes (all fields ``[Ez, Ey*Ex + 2*pad]``)."""

    _fields = ("ext_px", "ext_py", "ext_pz", "flat_idx", "counts_max")

    def __init__(self, ext_px, ext_py, ext_pz, flat_idx, counts_max,
                 dims, radius, pbc):
        self.ext_px = ext_px
        self.ext_py = ext_py
        self.ext_pz = ext_pz
        self.flat_idx = flat_idx          # [N] interior voxel id (z-major)
        self.counts_max = counts_max      # max atoms in one voxel (must be 1)
        self.dims = tuple(dims)           # (Cz, Cy, Cx)
        self.radius = tuple(radius)       # (Rz, Ry, Rx)
        self.pbc = tuple(bool(b) for b in pbc)  # (x, y, z) order

    # -- static geometry helpers -------------------------------------------
    @property
    def ext_dims(self):
        cz, cy, cx = self.dims
        rz, ry, rx = self.radius
        return cz + 2 * rz, cy + 2 * ry, cx + 2 * rx

    @property
    def col_pad(self):
        _, ry, rx = self.radius
        _, _, ex = self.ext_dims
        return ry * ex + rx

    @property
    def flat_width(self):
        _, ey, ex = self.ext_dims
        return ey * ex + 2 * self.col_pad

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._fields)
        return children, (self.dims, self.radius, self.pbc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dims, radius, pbc = aux
        return cls(*children, dims=dims, radius=radius, pbc=pbc)


def _extend3(plane, radius, pbc, fill):
    """Halo-pad a [Cz, Cy, Cx] plane (wrap on periodic axes, const else)."""
    rz, ry, rx = radius
    out = plane
    # axis order of plane: (z, y, x); pbc tuple is (x, y, z)
    for ax, (r, per) in enumerate(((rz, pbc[2]), (ry, pbc[1]), (rx, pbc[0]))):
        if r == 0:
            continue
        cfg = [(0, 0)] * out.ndim
        cfg[ax] = (r, r)
        if per:
            out = jnp.pad(out, cfg, mode="wrap")
        else:
            out = jnp.pad(out, cfg, mode="constant", constant_values=fill)
    return out


def _flatten_cols(ext3, col_pad, fill):
    """[Ez, Ey, Ex] -> [Ez, Ey*Ex + 2*pad] with constant column padding."""
    ez = ext3.shape[0]
    flat = ext3.reshape(ez, -1)
    return jnp.pad(flat, ((0, 0), (col_pad, col_pad)),
                   mode="constant", constant_values=fill)


def extend_stencil(sg: StencilGrid, plane, fill):
    """Interior [Cz, Cy, Cx] plane -> sweep-ready flat [Ez, F] plane."""
    return _flatten_cols(_extend3(plane, sg.radius, sg.pbc, fill),
                         sg.col_pad, fill)


def scatter_to_stencil(sg: StencilGrid, values, fill=0.0):
    """Per-atom values -> interior [Cz, Cy, Cx] plane (occupancy-1 slots)."""
    cz, cy, cx = sg.dims
    buf = jnp.full((cz * cy * cx,), fill, dtype=jnp.asarray(values).dtype)
    return buf.at[sg.flat_idx].set(values).reshape(cz, cy, cx)


def gather_from_stencil(sg: StencilGrid, plane):
    """Interior [Cz, Cy, Cx] plane -> per-atom values."""
    return plane.reshape(-1)[sg.flat_idx]


def gather_rows_from_stencil(sg: StencilGrid, planes):
    """One [voxels, k] row gather for k interior planes (in place of k
    separate per-atom gathers)."""
    stacked = jnp.stack([p.reshape(-1) for p in planes], axis=-1)
    rows = stacked[sg.flat_idx]
    return tuple(rows[..., i] for i in range(len(planes)))


@partial(jax.jit, static_argnames=("dims", "radius", "pbc_t"))
def _build_stencil_impl(positions, cell, dims, radius, pbc_t, origin):
    n = positions.shape[0]
    dtype = positions.dtype
    cz, cy, cx = dims
    rz, ry, rx = radius
    cpd_xyz = jnp.asarray([cx, cy, cz], dtype=INDEX_DTYPE)
    pbc_arr = jnp.asarray(pbc_t, dtype=bool)

    inv_cell = jnp.linalg.inv(cell)
    frac = apply_mat3(positions, inv_cell)
    bin_pos = frac * cpd_xyz.astype(dtype)
    if origin is not None:
        bin_pos = bin_pos - jnp.asarray(origin, dtype=dtype).reshape(1, 3)
    coords = jnp.floor(bin_pos).astype(INDEX_DTYPE)
    wrap = jnp.floor_divide(coords, cpd_xyz)
    wrapped = coords - wrap * cpd_xyz
    clamped = jnp.clip(coords, 0, cpd_xyz - 1)
    ccoords = jnp.where(pbc_arr[None, :], wrapped, clamped)
    aps = jnp.where(pbc_arr[None, :], wrap, 0)

    shift_cart = apply_mat3(aps.astype(dtype), cell)
    wpx = positions[:, 0] - shift_cart[:, 0]
    wpy = positions[:, 1] - shift_cart[:, 1]
    wpz = positions[:, 2] - shift_cart[:, 2]

    lin = ccoords[:, 0] + cx * (ccoords[:, 1] + cy * ccoords[:, 2])
    ncells = cx * cy * cz
    counts = jnp.zeros((ncells,), INDEX_DTYPE).at[lin].add(1)
    counts_max = jnp.max(counts)

    def scat(vals, fill):
        buf = jnp.full((ncells,), fill, dtype=vals.dtype)
        return buf.at[lin].set(vals).reshape(cz, cy, cx)

    g_px = scat(wpx, 0.0)
    g_py = scat(wpy, 0.0)
    g_pz = scat(wpz, 0.0)
    occupied = scat(jnp.ones((n,), dtype=bool), False)

    # park empty voxels at unique far-away x (displacement validity)
    vox_iota = jnp.arange(ncells, dtype=dtype).reshape(cz, cy, cx)
    g_px = g_px + jnp.where(occupied, 0.0, DISPLACE + vox_iota * DISPLACE_SPACING)

    ext_px3 = _extend3(g_px, radius, pbc_t, DISPLACE)
    ext_py3 = _extend3(g_py, radius, pbc_t, 0.0)
    ext_pz3 = _extend3(g_pz, radius, pbc_t, 0.0)

    # ghost images carry their box shift pre-applied (same as grid.py build)
    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx
    iz = jax.lax.broadcasted_iota(INDEX_DTYPE, (ez, ey, ex), 0)
    iy = jax.lax.broadcasted_iota(INDEX_DTYPE, (ez, ey, ex), 1)
    ix = jax.lax.broadcasted_iota(INDEX_DTYPE, (ez, ey, ex), 2)
    sz = jnp.floor_divide(iz - rz, jnp.asarray(cz, INDEX_DTYPE))
    sy = jnp.floor_divide(iy - ry, jnp.asarray(cy, INDEX_DTYPE))
    sx = jnp.floor_divide(ix - rx, jnp.asarray(cx, INDEX_DTYPE))
    sxf, syf, szf = sx.astype(dtype), sy.astype(dtype), sz.astype(dtype)
    shx = sxf * cell[0, 0] + syf * cell[1, 0] + szf * cell[2, 0]
    shy = sxf * cell[0, 1] + syf * cell[1, 1] + szf * cell[2, 1]
    shz = sxf * cell[0, 2] + syf * cell[1, 2] + szf * cell[2, 2]
    ext_px3 = ext_px3 + shx
    ext_py3 = ext_py3 + shy
    ext_pz3 = ext_pz3 + shz

    col_pad = ry * ex + rx
    return (
        _flatten_cols(ext_px3, col_pad, DISPLACE),
        _flatten_cols(ext_py3, col_pad, 0.0),
        _flatten_cols(ext_pz3, col_pad, 0.0),
        lin,
        counts_max,
    )


def build_stencil_grid(positions, cell, pbc, dims, radius,
                       origin=None) -> StencilGrid:
    """Bin atoms into occupancy-1 voxels and build the flat halo planes.

    The occupancy-1 precondition is NOT enforced here (that would sync);
    check ``counts_max`` (or use :func:`build_stencil_auto`, which
    validates host-side).  A voxel holding two atoms keeps only one —
    results are then wrong, exactly like a row-grid capacity overflow.
    """
    dtype = positions.dtype
    cell = jnp.asarray(cell, dtype=dtype).reshape(3, 3)
    pbc_t = tuple(bool(b) for b in np.asarray(jax.device_get(pbc)).reshape(-1)[:3])
    ext_px, ext_py, ext_pz, flat_idx, counts_max = _build_stencil_impl(
        positions, cell, tuple(dims), tuple(radius), pbc_t,
        None if origin is None else jnp.asarray(origin, dtype),
    )
    return StencilGrid(ext_px, ext_py, ext_pz, flat_idx, counts_max,
                       dims=tuple(dims), radius=tuple(radius), pbc=pbc_t)


def choose_stencil_geometry(positions, cell, pbc, cutoff: float,
                            bins_per_cutoff=(3, 4, 2, 5)):
    """Search for a commensurate occupancy-1 binning (host-side syncs).

    Tries ``k`` bins per cutoff per candidate ``k`` (finest sweep-cost
    winner first), with the half-bin origin search of
    ``grid.choose_grid_origin`` adapted per geometry.  Returns
    ``(dims, radius, origin, max_occupancy)`` of the cheapest valid
    geometry, or ``None`` if no candidate reaches occupancy 1 (caller
    falls back to the row sweep).
    """
    cell_np = np.asarray(jax.device_get(cell), dtype=np.float64).reshape(3, 3)
    pbc_np = np.asarray(jax.device_get(pbc), dtype=bool).reshape(-1)[:3]
    inv_t = np.linalg.inv(cell_np).T
    face = 1.0 / np.linalg.norm(inv_t, axis=1)
    dtype = positions.dtype

    pbc_j = jnp.asarray(pbc_np)

    @partial(jax.jit, static_argnames=("dims",))
    def max_occ(dims, origin):
        cz, cy, cx = dims
        cpd_xyz = jnp.asarray([cx, cy, cz], INDEX_DTYPE)
        frac = apply_mat3(positions, jnp.linalg.inv(jnp.asarray(cell, dtype)))
        bp = frac * cpd_xyz.astype(dtype) - origin.reshape(1, 3)
        coords = jnp.floor(bp).astype(INDEX_DTYPE)
        wrapped = coords - jnp.floor_divide(coords, cpd_xyz) * cpd_xyz
        clamped = jnp.clip(coords, 0, cpd_xyz - 1)
        # same binning rule as the build: wrap on periodic axes, clamp else
        ccoords = jnp.where(pbc_j[None, :], wrapped, clamped)
        lin = ccoords[:, 0] + cx * (ccoords[:, 1] + cy * ccoords[:, 2])
        counts = jnp.zeros((cx * cy * cz,), INDEX_DTYPE).at[lin].add(1)
        return jnp.max(counts)

    best = None
    for k in bins_per_cutoff:
        cpd = np.maximum(np.round(face * k / float(cutoff)).astype(np.int64), 1)
        radius = np.ceil(cutoff * cpd / face - 1e-9).astype(np.int64)
        if (radius[pbc_np] > cpd[pbc_np]).any():
            continue
        dims = (int(cpd[2]), int(cpd[1]), int(cpd[0]))
        rad = (int(radius[2]), int(radius[1]), int(radius[0]))
        ncells = int(np.prod(cpd))
        # half-space offset count x cells ~ sweep cost
        n_off = ((2 * rad[0] + 1) * (2 * rad[1] + 1) * (2 * rad[2] + 1) - 1) // 2
        cost = n_off * ncells
        for o in ([0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.0, 0.0],
                  [0.0, 0.5, 0.5]):
            occ = int(jax.device_get(max_occ(dims, jnp.asarray(o, dtype))))
            if occ <= 1 and (best is None or cost < best[4]):
                best = (dims, rad, np.asarray(o), occ, cost)
                break
    if best is None:
        return None
    return best[0], best[1], best[2], best[3]


def build_stencil_auto(positions, cell, pbc, cutoff: float):
    """Geometry search + validated build; ``None`` if no occupancy-1
    binning exists (fall back to ``grid.build_atom_grid_auto``)."""
    geo = choose_stencil_geometry(positions, cell, pbc, cutoff)
    if geo is None:
        return None
    dims, radius, origin, _ = geo
    sg = build_stencil_grid(positions, cell, pbc, dims, radius,
                            origin=None if not origin.any() else origin)
    if int(jax.device_get(sg.counts_max)) > 1:
        return None
    return sg


def _half_space_offsets(radius):
    rz, ry, rx = radius
    offs = []
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                if dz > 0 or (dz == 0 and dy > 0) or (dz == 0 and dy == 0 and dx > 0):
                    offs.append((dz, dy, dx))
    return offs


def stencil_reduce_sym(sg: StencilGrid, kernel, init, num_ext_acc: int,
                       extra_ext_planes=(), extra_own_planes=()):
    """Half-space voxel sweep with symmetric accumulation.

    ``kernel(carry, own, cand) -> (carry, deltas)`` sees flat ``[Cz, W0]``
    planes (W0 = Ey*Ex, the y/x halo inline — halo own slots are parked and
    contribute zero) and returns per-slot j-side ``deltas`` (tuple of
    ``num_ext_acc`` arrays [Cz, W0]).  Every pair is visited exactly once.
    Returns ``(carry, folded_interior_accumulators)`` with each accumulator
    [Cz, Cy, Cx].  Own-side carries can be finalized with
    :func:`own_interior`.
    """
    rz, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    ez, ey, ex = sg.ext_dims
    pad = sg.col_pad
    W0 = ey * ex
    dtype = sg.ext_px.dtype

    ext = {"px": sg.ext_px, "py": sg.ext_py, "pz": sg.ext_pz}
    for name, plane in extra_ext_planes:
        ext[name] = plane
    # own side: interior atoms only, halo columns parked on the negative
    # displacement band (ghost copies as "own" would double-count pairs)
    own = {
        "px": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_px),
                                     -DISPLACE),
        "py": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_py)),
        "pz": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_pz)),
    }
    for name, plane in extra_own_planes:
        own[name] = plane

    ext_acc = [jnp.zeros((ez, sg.flat_width), dtype) for _ in range(num_ext_acc)]
    carry = init

    # (dz, dy) half-space with the x-shifts folded per offset: the 2*Rx+1
    # dx variants of one (dz, dy) share their candidate rows, so looping
    # them inside one delta-fold keeps the whole group a single XLA fusion
    # cluster and one accumulator update — 171 tiny kernels collapse to
    # ~25 big ones.
    zy_offsets = [(0, 0)] + [
        (dz, dy)
        for dz in range(-rz, rz + 1)
        for dy in range(-ry, ry + 1)
        if dz > 0 or (dz == 0 and dy > 0)
    ]
    for dz, dy in zy_offsets:
        dxs = range(1, rx + 1) if (dz, dy) == (0, 0) else range(-rx, rx + 1)
        base = dy * ex
        comb = [jnp.zeros((cz, W0 + 2 * rx), dtype) for _ in range(num_ext_acc)]
        for dx in dxs:
            shift = base + dx
            cand = {name: p[rz + dz:rz + dz + cz, pad + shift:pad + shift + W0]
                    for name, p in ext.items()}
            carry, deltas = kernel(carry, own, cand)
            for k, d in enumerate(deltas):
                comb[k] = comb[k].at[:, rx + dx:rx + dx + W0].add(d)
        c0 = pad + base - rx
        for k in range(num_ext_acc):
            ext_acc[k] = ext_acc[k].at[
                rz + dz:rz + dz + cz, c0:c0 + W0 + 2 * rx].add(comb[k])
    folded = tuple(fold_stencil(sg, a) for a in ext_acc)
    return carry, folded


def fold_stencil(sg: StencilGrid, acc):
    """Fold a flat [Ez, F] accumulator's halo back onto the interior."""
    rz, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    ez, ey, ex = sg.ext_dims
    pad = sg.col_pad
    a = acc[:, pad:pad + ey * ex].reshape(ez, ey, ex)
    if rz:
        core = a[rz:rz + cz]
        core = core.at[:rz].add(a[rz + cz:rz + cz + rz])
        core = core.at[cz - rz:].add(a[0:rz])
        a = core
    else:
        a = a[0:cz]
    if ry:
        core = a[:, ry:ry + cy]
        core = core.at[:, :ry].add(a[:, ry + cy:ry + cy + ry])
        core = core.at[:, cy - ry:].add(a[:, 0:ry])
        a = core
    else:
        a = a[:, 0:cy]
    if rx:
        core = a[:, :, rx:rx + cx]
        core = core.at[:, :, :rx].add(a[:, :, rx + cx:rx + cx + rx])
        core = core.at[:, :, cx - rx:].add(a[:, :, 0:rx])
        a = core
    else:
        a = a[:, :, 0:cx]
    return a


def own_interior(sg: StencilGrid, acc):
    """Own-side [Cz, W0] accumulator -> interior [Cz, Cy, Cx]."""
    _, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    _, ey, ex = sg.ext_dims
    return acc.reshape(cz, ey, ex)[:, ry:ry + cy, rx:rx + cx]


def own_flat_from_interior(sg: StencilGrid, plane, fill=0.0):
    """Interior [Cz, Cy, Cx] plane -> own-side flat [Cz, Ey*Ex] plane.

    The own side of the sweep must NOT see the halo's ghost atoms (each
    pair would be visited twice: once from the interior owner and once
    from its ghost copy), so own slots in the y/x halo band are constant-
    filled — parked via ``fill=-DISPLACE`` for the position plane, which
    fails every distance test against any candidate (real, ghost, or
    positively-parked empty).
    """
    _, ry, rx = sg.radius
    padded = jnp.pad(plane, ((0, 0), (ry, ry), (rx, rx)),
                     mode="constant", constant_values=fill)
    return padded.reshape(plane.shape[0], -1)


def _interior_of_ext(sg: StencilGrid, ext_plane):
    rz, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    _, ey, ex = sg.ext_dims
    pad = sg.col_pad
    flat = ext_plane[rz:rz + cz, pad:pad + ey * ex]
    return flat.reshape(cz, ey, ex)[:, ry:ry + cy, rx:rx + cx]


# ---------------------------------------------------------------------------
# Pair kernels in voxel form (same math as the row-sweep bodies)
# ---------------------------------------------------------------------------


_ENGINES = ("xla", "stack", "fuse")


def _resolve_engine(engine):
    """``None`` -> the half-space fold sweep; unknown names raise."""
    if engine is None:
        return "xla"
    if engine not in _ENGINES:
        raise ValueError(
            f"unknown stencil engine {engine!r}; expected one of {_ENGINES}")
    return engine


def _full_offsets(radius):
    rz, ry, rx = radius
    return [
        (dz, dy, dx)
        for dz in range(-rz, rz + 1)
        for dy in range(-ry, ry + 1)
        for dx in range(-rx, rx + 1)
        if (dz, dy, dx) != (0, 0, 0)
    ]


# Full-space pair bodies (same math as the half-space kernels below;
# energies split half to each side, forces/CN accumulate per own atom)


def _geom(own, cand, cutoff_sq):
    dx = cand["px"] - own["px"]
    dy = cand["py"] - own["py"]
    dz = cand["pz"] - own["pz"]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (d2 < cutoff_sq) & (d2 > 1e-20)
    r2m = jnp.where(ok, d2, 1.0)
    inv_r = jax.lax.rsqrt(r2m)
    return ok, inv_r, r2m, dx, dy, dz


def _coulomb_body(cutoff, alpha):
    """Per-slot (damped-)Coulomb body for the fullspace stencil sweep.

    Returns ``body(own, cand) -> (e_pair, fx, fy, fz)`` matching
    the full-space sweeps' contract; same math as
    ``grid._coulomb_impl`` (reference: electrostatics/coulomb.py kernels).
    """
    cutoff_sq = float(cutoff) ** 2
    alpha_t = float(alpha)
    two_over_sqrt_pi = 1.1283791670955126

    def body(own, cand):
        ok, inv_r, r2m, dx, dy, dz = _geom(own, cand, cutoff_sq)
        qq = own["q"] * cand["q"]
        if alpha_t > 0:
            ar = alpha_t * (r2m * inv_r)
            erfc_ar = erfc_approx(ar)
            phi = erfc_ar * inv_r
            mag = (erfc_ar * inv_r
                   + two_over_sqrt_pi * alpha_t * jnp.exp(-ar * ar)
                   ) * inv_r * inv_r
        else:
            phi = inv_r
            mag = inv_r * inv_r * inv_r
        e_pair = jnp.where(ok, 0.5 * qq * phi, 0.0)
        coef = jnp.where(ok, qq * mag, 0.0)
        # force on own atom: -sum coef * d (d points own -> cand)
        return e_pair, -coef * dx, -coef * dy, -coef * dz

    return body


def _cn_body(cutoff, k1):
    """D3 coordination-number body (logistic counting fn) for the
    fullspace stencil sweep (reference: dispersion/dftd3.py:832-940)."""
    cutoff_sq = float(cutoff) ** 2
    k1 = float(k1)

    def body(own, cand):
        ok, inv_r, _r2m, *_ = _geom(own, cand, cutoff_sq)
        rc = own["rcov"] + cand["rcov"]
        f = jnp.where(ok, 1.0 / (1.0 + jnp.exp(-k1 * (rc * inv_r - 1.0))), 0.0)
        return (f,)

    return body


def _chain_body(cutoff, k1):
    """D3 CN chain-rule force body for the fullspace stencil sweep
    (reference: dispersion/dftd3.py:1133-1258)."""
    cutoff_sq = float(cutoff) ** 2
    k1 = float(k1)

    def body(own, cand):
        ok, inv_r, _r2m, dx, dy, dz = _geom(own, cand, cutoff_sq)
        rc = own["rcov"] + cand["rcov"]
        rrq = rc * inv_r
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rrq - 1.0)))
        dcn_dr_r = -f_cn * (1.0 - f_cn) * k1 * rrq * inv_r * inv_r
        coef = jnp.where(ok, (own["decn"] + cand["decn"]) * dcn_dr_r, 0.0)
        return coef * dx, coef * dy, coef * dz

    return body


def stencil_sweep_fullspace_stack(sg: StencilGrid, ext_named, own_named,
                                  body, num_out: int, group: int = 114):
    """Full-space own-only sweep via materialized shifted-view stacks.

    Full-space sweep contract (all ``(2R+1)^3 - 1`` offsets, own-side
    accumulation only, energies split half to each side): each group of
    offsets becomes one stacked candidate tensor ``[G, Cz, W0]`` per
    plane and one broadcast body + offset-axis reduce — a single wide
    fusion with no carry chain, at the cost of materializing the stacks
    and 2x the pair visits of the half-space fold.
    """
    rz, ry, rx = sg.radius
    cz = sg.dims[0]
    ez, ey, ex = sg.ext_dims
    pad = sg.col_pad
    W0 = ey * ex
    dtype = sg.ext_px.dtype
    offsets = _full_offsets(sg.radius)

    ext = [("px", sg.ext_px), ("py", sg.ext_py), ("pz", sg.ext_pz)]
    ext += list(ext_named)
    own = {
        "px": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_px),
                                     -DISPLACE),
        "py": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_py)),
        "pz": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_pz)),
    }
    for name, plane in own_named:
        own[name] = plane

    acc = [jnp.zeros((cz, W0), dtype) for _ in range(num_out)]
    for g0 in range(0, len(offsets), group):
        chunk = offsets[g0:g0 + group]
        cand = {
            name: jnp.stack([
                jax.lax.slice(plane, (rz + dz, pad + dy * ex + dx),
                              (rz + dz + cz, pad + dy * ex + dx + W0))
                for dz, dy, dx in chunk
            ])
            for name, plane in ext
        }
        outs = body(own, cand)
        acc = [a + o.sum(axis=0) for a, o in zip(acc, outs)]
    return tuple(acc)


def stencil_sweep_fullspace_fused(sg: StencilGrid, ext_named, own_named,
                                  body, num_out: int):
    """Full-space own-only sweep as one flat add-tree of per-offset bodies.

    Same contract as :func:`stencil_sweep_fullspace_stack` but nothing is
    materialized: every offset's candidate planes are direct (overlapping)
    slices of the ext planes and the per-offset body outputs are summed in
    a balanced pairwise tree, leaving XLA one wide fusion with [Cz, W0]
    intermediates only.
    """
    rz, ry, rx = sg.radius
    cz = sg.dims[0]
    ez, ey, ex = sg.ext_dims
    pad = sg.col_pad
    W0 = ey * ex

    ext = [("px", sg.ext_px), ("py", sg.ext_py), ("pz", sg.ext_pz)]
    ext += list(ext_named)
    own = {
        "px": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_px),
                                     -DISPLACE),
        "py": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_py)),
        "pz": own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_pz)),
    }
    for name, plane in own_named:
        own[name] = plane

    parts = []
    for dz, dy, dx in _full_offsets(sg.radius):
        cand = {
            name: jax.lax.slice(plane, (rz + dz, pad + dy * ex + dx),
                                (rz + dz + cz, pad + dy * ex + dx + W0))
            for name, plane in ext
        }
        parts.append(body(own, cand))
    # balanced pairwise tree keeps the reduction depth ~log2(n_offsets)
    while len(parts) > 1:
        nxt = [
            tuple(a + b for a, b in zip(parts[i], parts[i + 1]))
            if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
        parts = nxt
    return parts[0]


def stencil_coulomb_energy_forces(sg: StencilGrid, charges, cutoff,
                                  alpha=0.0, engine: str | None = None):
    """(Damped-)Coulomb per-atom energies/forces on the voxel stencil.

    Numerically matches ``grid.grid_coulomb_energy_forces`` (same pair
    math, different traversal order).  ``engine``: ``"xla"`` (default;
    half-space fold sweep and reference implementation), ``"stack"`` or
    ``"fuse"`` (full-space sweeps, see :func:`stencil_sweep_fullspace_stack`
    and :func:`stencil_sweep_fullspace_fused`); other names raise
    ``ValueError``.
    """
    dtype = sg.ext_px.dtype
    cutoff_sq = float(cutoff) ** 2
    alpha_t = float(alpha)
    two_over_sqrt_pi = 1.1283791670955126
    cz, cy, cx = sg.dims

    q_int = scatter_to_stencil(sg, jnp.asarray(charges, dtype))
    q_ext = extend_stencil(sg, q_int, 0.0)

    eng = _resolve_engine(engine)
    if eng in ("stack", "fuse"):
        ext_named = (("q", q_ext),)
        own_named = (("q", own_flat_from_interior(sg, q_int)),)
        if eng == "stack":
            e, fx, fy, fz = stencil_sweep_fullspace_stack(
                sg, ext_named, own_named, _coulomb_body(cutoff, alpha), 4)
        else:
            e, fx, fy, fz = stencil_sweep_fullspace_fused(
                sg, ext_named, own_named, _coulomb_body(cutoff, alpha), 4)
        e_pl = own_interior(sg, e)
        fx_pl = own_interior(sg, fx)
        fy_pl = own_interior(sg, fy)
        fz_pl = own_interior(sg, fz)
        energies = gather_from_stencil(sg, e_pl)
        forces = jnp.stack(
            [gather_from_stencil(sg, fx_pl), gather_from_stencil(sg, fy_pl),
             gather_from_stencil(sg, fz_pl)],
            axis=-1,
        )
        return energies, forces

    def kern(carry, own, cand):
        e, fx, fy, fz = carry
        dx = cand["px"] - own["px"]
        dy = cand["py"] - own["py"]
        dz = cand["pz"] - own["pz"]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-20)
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        qq = own["q"] * cand["q"]
        if alpha_t > 0:
            r = jnp.where(ok, d2, 1.0) * inv_r
            ar = alpha_t * r
            erfc_ar = erfc_approx(ar)
            phi = erfc_ar * inv_r
            mag = (erfc_ar * inv_r
                   + two_over_sqrt_pi * alpha_t * jnp.exp(-ar * ar)) * inv_r * inv_r
        else:
            phi = inv_r
            mag = inv_r * inv_r * inv_r
        e_pair = jnp.where(ok, 0.5 * qq * phi, 0.0)
        coef = jnp.where(ok, qq * mag, 0.0)
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        return (e + e_pair, fx - cfx, fy - cfy, fz - cfz), (e_pair, cfx, cfy, cfz)

    ez_w = (cz, sg.ext_dims[1] * sg.ext_dims[2])
    zeros = jnp.zeros(ez_w, dtype)
    (e, fx, fy, fz), (e2, fx2, fy2, fz2) = stencil_reduce_sym(
        sg, kern, (zeros, zeros, zeros, zeros), 4,
        extra_ext_planes=(("q", q_ext),),
        extra_own_planes=(("q", own_flat_from_interior(sg, q_int)),),
    )
    e_pl = own_interior(sg, e) + e2
    fx_pl = own_interior(sg, fx) + fx2
    fy_pl = own_interior(sg, fy) + fy2
    fz_pl = own_interior(sg, fz) + fz2
    energies = gather_from_stencil(sg, e_pl)
    forces = jnp.stack(
        [gather_from_stencil(sg, fx_pl), gather_from_stencil(sg, fy_pl),
         gather_from_stencil(sg, fz_pl)],
        axis=-1,
    )
    return energies, forces


def stencil_coordination_numbers(sg: StencilGrid, rcov_per_atom, cutoff,
                                 k1=16.0, engine: str | None = None,
                                 rcov_planes=None):
    """DFT-D3 coordination numbers on the voxel stencil.

    Same math as ``grid.grid_coordination_numbers`` /
    ``grid_d3.make_d3_row_kernels``'s CN pass (reference 4-pass pipeline,
    dispersion/dftd3.py:832-940), voxel traversal.  ``rcov_planes``
    optionally supplies prebuilt ``(interior, extended)`` rcov planes so
    a caller running several stencil passes (the hybrid D3 engine)
    scatters them once.
    """
    dtype = sg.ext_px.dtype
    cutoff_sq = float(cutoff) ** 2
    k1 = float(k1)
    cz = sg.dims[0]

    if rcov_planes is None:
        rcov_int = scatter_to_stencil(sg, jnp.asarray(rcov_per_atom, dtype))
        rcov_ext = extend_stencil(sg, rcov_int, 0.0)
    else:
        rcov_int, rcov_ext = rcov_planes

    eng = _resolve_engine(engine)
    if eng in ("stack", "fuse"):
        ext_named = (("rcov", rcov_ext),)
        own_named = (("rcov", own_flat_from_interior(sg, rcov_int)),)
        if eng == "stack":
            (cn,) = stencil_sweep_fullspace_stack(
                sg, ext_named, own_named, _cn_body(cutoff, k1), 1)
        else:
            (cn,) = stencil_sweep_fullspace_fused(
                sg, ext_named, own_named, _cn_body(cutoff, k1), 1)
        return gather_from_stencil(sg, own_interior(sg, cn))

    def kern(cn, own, cand):
        dx = cand["px"] - own["px"]
        dy = cand["py"] - own["py"]
        dz = cand["pz"] - own["pz"]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-20)
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        rc = own["rcov"] + cand["rcov"]
        f = jnp.where(ok, 1.0 / (1.0 + jnp.exp(-k1 * (rc * inv_r - 1.0))), 0.0)
        return cn + f, (f,)

    zeros = jnp.zeros((cz, sg.ext_dims[1] * sg.ext_dims[2]), dtype)
    cn, (cn2,) = stencil_reduce_sym(
        sg, kern, zeros, 1,
        extra_ext_planes=(("rcov", rcov_ext),),
        extra_own_planes=(("rcov", own_flat_from_interior(sg, rcov_int)),),
    )
    return gather_from_stencil(sg, own_interior(sg, cn) + cn2)


def stencil_cn_chain_forces(sg: StencilGrid, rcov_per_atom, decn_per_atom,
                            cutoff, k1=16.0, engine: str | None = None,
                            rcov_planes=None):
    """D3 CN chain-rule force contribution on the voxel stencil.

    ``F_i += sum_j (dE/dCN_i + dE/dCN_j) dCN_ij/dr_ij r_hat`` — the same
    pass-3 body as ``grid_d3.make_d3_row_kernels``'s ``chain_kern``
    (reference: dispersion/dftd3.py:1133-1258).  Returns forces [N, 3].
    """
    dtype = sg.ext_px.dtype
    cutoff_sq = float(cutoff) ** 2
    k1 = float(k1)
    cz = sg.dims[0]

    if rcov_planes is None:
        rcov_int = scatter_to_stencil(sg, jnp.asarray(rcov_per_atom, dtype))
        rcov_ext = extend_stencil(sg, rcov_int, 0.0)
    else:
        rcov_int, rcov_ext = rcov_planes
    decn_int = scatter_to_stencil(sg, jnp.asarray(decn_per_atom, dtype))
    decn_ext = extend_stencil(sg, decn_int, 0.0)

    eng = _resolve_engine(engine)
    if eng in ("stack", "fuse"):
        ext_named = (("rcov", rcov_ext), ("decn", decn_ext))
        own_named = (("rcov", own_flat_from_interior(sg, rcov_int)),
                     ("decn", own_flat_from_interior(sg, decn_int)))
        if eng == "stack":
            fx, fy, fz = stencil_sweep_fullspace_stack(
                sg, ext_named, own_named, _chain_body(cutoff, k1), 3)
        else:
            fx, fy, fz = stencil_sweep_fullspace_fused(
                sg, ext_named, own_named, _chain_body(cutoff, k1), 3)
        return jnp.stack(gather_rows_from_stencil(
            sg, (own_interior(sg, fx), own_interior(sg, fy),
                 own_interior(sg, fz))), axis=-1)

    def kern(carry, own, cand):
        fx_a, fy_a, fz_a = carry
        dx = cand["px"] - own["px"]
        dy = cand["py"] - own["py"]
        dz = cand["pz"] - own["pz"]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-20)
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        rc = own["rcov"] + cand["rcov"]
        rrq = rc * inv_r
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rrq - 1.0)))
        dcn_dr_r = -f_cn * (1.0 - f_cn) * k1 * rrq * inv_r * inv_r
        coef = jnp.where(ok, (own["decn"] + cand["decn"]) * dcn_dr_r, 0.0)
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        return (fx_a + cfx, fy_a + cfy, fz_a + cfz), (-cfx, -cfy, -cfz)

    zeros = jnp.zeros((cz, sg.ext_dims[1] * sg.ext_dims[2]), dtype)
    (fx, fy, fz), (fx2, fy2, fz2) = stencil_reduce_sym(
        sg, kern, (zeros, zeros, zeros), 3,
        extra_ext_planes=(("rcov", rcov_ext), ("decn", decn_ext)),
        extra_own_planes=(("rcov", own_flat_from_interior(sg, rcov_int)),
                          ("decn", own_flat_from_interior(sg, decn_int))),
    )
    fx_pl = own_interior(sg, fx) + fx2
    fy_pl = own_interior(sg, fy) + fy2
    fz_pl = own_interior(sg, fz) + fz2
    return jnp.stack(
        gather_rows_from_stencil(sg, (fx_pl, fy_pl, fz_pl)), axis=-1)
