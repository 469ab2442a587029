# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) compute core — SoA / packed-shift formulation.

Same physics as dftd3.py's public module docstring; this file holds the
chunked sweeps in a form shaped by two layout rules:

1. No array carries a thin trailing dimension of 3 or (5, 5): `[N, C, 3]`
   or `[N, C, 5, 5]` gathers multiply the memory traffic of every
   chunk.  Geometry is computed
   as separate x/y/z planes; shifts travel bit-packed (one int32 per pair);
   the C6/CN reference tables are flattened to 1-D and gathered per
   reference point as clean 2-D `[N, C]` loads.
2. The 5x5 C6 interpolation runs as a statically unrolled loop with
   *online-softmax* accumulation — exact log-sum-exp stabilization in one
   pass (the reference needs two passes over the grid,
   dftd3.py:495-540).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.neighborlist.neighbor_utils import unpack_shifts

NEG_BIG = -1e20


def _geometry(positions_xyz, numbers, nm_chunk, packed_chunk, cell_rows, batch_idx,
              fill_value, periodic):
    """Component-wise pair geometry for one neighbor-column chunk.

    ``cell_rows`` is a tuple of 9 per-atom (or scalar) cell components
    (c00..c22) so batched cells cost one gather per component, not an
    [N, C, 3, 3] monster.
    """
    px, py, pz = positions_xyz
    n = px.shape[0]
    valid = (nm_chunk < fill_value) & (nm_chunk >= 0)
    j = jnp.clip(nm_chunk, 0, max(n - 1, 0))
    valid &= (numbers[j] != 0) & (numbers[:, None] != 0)

    if periodic:
        sx, sy, sz = unpack_shifts(packed_chunk)
        dtype = px.dtype
        sxf = sx.astype(dtype)
        syf = sy.astype(dtype)
        szf = sz.astype(dtype)
        c00, c01, c02, c10, c11, c12, c20, c21, c22 = cell_rows
        shx = sxf * c00 + syf * c10 + szf * c20
        shy = sxf * c01 + syf * c11 + szf * c21
        shz = sxf * c02 + syf * c12 + szf * c22
        dx = px[j] + shx - px[:, None]
        dy = py[j] + shy - py[:, None]
        dz = pz[j] + shz - pz[:, None]
    else:
        dx = px[j] - px[:, None]
        dy = py[j] - py[:, None]
        dz = pz[j] - pz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0)) * (r2 > 0)
    valid &= r > 1e-12
    r_safe = jnp.where(valid, r, 1.0)
    return valid, j, dx, dy, dz, r, r_safe


def _c6_online(cn_i, cn_j, base_ij, base_ji, c6_flat, cnref_flat, k3, mesh: int):
    """C6(CN) interpolation, statically unrolled with online-LSE accumulation.

    cn_i: [N, 1]; cn_j, base_ij, base_ji: [N, C] (flat table row offsets,
    already multiplied by mesh^2).  Returns (c6, dC6/dCN_i, dC6/dCN_j).
    """
    shape = cn_j.shape
    dt = cn_j.dtype
    m = jnp.full(shape, NEG_BIG, dtype=dt)
    w = jnp.zeros(shape, dt)
    z = jnp.zeros(shape, dt)
    w_di = jnp.zeros(shape, dt)
    w_dj = jnp.zeros(shape, dt)
    z_di = jnp.zeros(shape, dt)
    z_dj = jnp.zeros(shape, dt)

    for p in range(mesh):
        for q in range(mesh):
            o_pq = p * mesh + q
            o_qp = q * mesh + p
            c6v = c6_flat[base_ij + o_pq]
            ca = cnref_flat[base_ij + o_pq]
            cb = cnref_flat[base_ji + o_qp]
            ref_ok = c6v != 0.0
            di = cn_i - ca
            dj = cn_j - cb
            arg = jnp.where(ref_ok, k3 * (di * di + dj * dj), NEG_BIG)
            m_new = jnp.maximum(m, arg)
            # rescale previous accumulators; m == NEG_BIG => w==0, scale irrelevant
            scale = jnp.exp(jnp.maximum(m - m_new, NEG_BIG))
            scale = jnp.where(m > 0.5 * NEG_BIG, scale, 0.0)
            l_pq = jnp.where(ref_ok, jnp.exp(arg - m_new), 0.0)
            w = w * scale + l_pq
            z = z * scale + c6v * l_pq
            w_di = w_di * scale + l_pq * di
            w_dj = w_dj * scale + l_pq * dj
            z_di = z_di * scale + c6v * l_pq * di
            z_dj = z_dj * scale + c6v * l_pq * dj
            m = m_new

    good = (m > 0.5 * NEG_BIG) & (w > 1e-12)
    w_safe = jnp.where(good, w, 1.0)
    c6 = jnp.where(good, z / w_safe, 0.0)
    factor = 2.0 * k3 / w_safe
    dc6_dcni = jnp.where(good, factor * (z_di - c6 * w_di), 0.0)
    dc6_dcnj = jnp.where(good, factor * (z_dj - c6 * w_dj), 0.0)
    return c6, dc6_dcni, dc6_dcnj


@partial(
    jax.jit,
    static_argnames=(
        "fill_value", "periodic", "num_systems", "compute_virial", "chunk", "mesh"
    ),
)
def dftd3_matrix_kernel(
    positions,
    numbers,
    neighbor_matrix,
    packed_shifts,
    cell_b,
    batch_idx,
    rcov,
    r4r2,
    c6ab,
    cn_ref,
    a1,
    a2,
    s8,
    k1,
    k3,
    s6,
    s5_on,
    s5_off,
    fill_value: int,
    periodic: bool,
    num_systems: int,
    compute_virial: bool,
    chunk: int = 128,
    mesh: int = 5,
):
    """Three chunked sweeps implementing the reference's 4-pass pipeline.

    ``packed_shifts`` is the bit-packed [N, K] shift matrix (see
    neighbor_utils.pack_shifts); tables arrive as the reference-shaped
    [Zmax+1, Zmax+1, 5, 5] arrays and are flattened internally.
    """
    n, k_total = neighbor_matrix.shape
    dtype = positions.dtype
    numbers = numbers.astype(INDEX_DTYPE)
    nm = neighbor_matrix.astype(INDEX_DTYPE)
    bidx = batch_idx.astype(INDEX_DTYPE) if batch_idx is not None else None

    num_chunks = max(1, -(-k_total // chunk))
    k_pad = num_chunks * chunk
    nm = jnp.pad(nm, ((0, 0), (0, k_pad - k_total)), constant_values=fill_value)
    sh = jnp.pad(packed_shifts.astype(INDEX_DTYPE), ((0, 0), (0, k_pad - k_total)))

    inv_w = jnp.where(s5_off > s5_on, 1.0 / jnp.maximum(s5_off - s5_on, 1e-30), 0.0)

    px = positions[:, 0]
    py = positions[:, 1]
    pz = positions[:, 2]
    pxyz = (px, py, pz)
    rcov_i = rcov[numbers]
    r4r2_i = r4r2[numbers]

    zmax1 = c6ab.shape[0]
    m2 = mesh * mesh
    c6_flat = c6ab.reshape(-1)
    cnref_flat = cn_ref.reshape(-1)

    if periodic:
        if bidx is not None and cell_b.shape[0] > 1:
            cr = tuple(
                cell_b[bidx, r, c][:, None] for r in range(3) for c in range(3)
            )
        else:
            cr = tuple(cell_b[0, r, c] for r in range(3) for c in range(3))
    else:
        cr = None

    def slice_chunk(c):
        zero = jnp.zeros((), INDEX_DTYPE)
        nm_c = jax.lax.dynamic_slice(nm, (zero, c), (n, chunk))
        sh_c = jax.lax.dynamic_slice(sh, (zero, c), (n, chunk))
        return nm_c, sh_c

    # ---- Pass 1: coordination numbers ------------------------------------
    def cn_body(cn_acc, c):
        nm_c, sh_c = slice_chunk(c)
        valid, j, _, _, _, _, r_safe = _geometry(
            pxyz, numbers, nm_c, sh_c, cr, bidx, fill_value, periodic
        )
        rcov_ij = rcov_i[:, None] + rcov[numbers[j]]
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rcov_ij / r_safe - 1.0)))
        return cn_acc + jnp.sum(jnp.where(valid, f_cn, 0.0), axis=1), None

    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * chunk
    coord_num, _ = jax.lax.scan(cn_body, jnp.zeros((n,), dtype=dtype), starts)

    # ---- Pass 2: energy, direct forces, dE/dCN, virial --------------------
    def direct_body(carry, c):
        e_acc, fx_a, fy_a, fz_a, decn_acc, vir_acc = carry
        nm_c, sh_c = slice_chunk(c)
        valid, j, dx, dy, dz, r, r_safe = _geometry(
            pxyz, numbers, nm_c, sh_c, cr, bidx, fill_value, periodic
        )
        z_j = numbers[j]
        cn_j = coord_num[j]
        base_ij = (numbers[:, None] * zmax1 + z_j) * m2
        base_ji = (z_j * zmax1 + numbers[:, None]) * m2
        c6, dc6_dcni, _ = _c6_online(
            coord_num[:, None], cn_j, base_ij, base_ji, c6_flat, cnref_flat, k3, mesh
        )
        pair_ok = valid & (c6 >= 1e-12)

        r4r2_ij = 3.0 * r4r2_i[:, None] * r4r2[z_j]
        r0 = a1 * jnp.sqrt(r4r2_ij) + a2
        r2_ = r_safe * r_safe
        r4 = r2_ * r2_
        r6 = r4 * r2_
        r8 = r4 * r4
        r0_2 = r0 * r0
        r0_6 = r0_2 * r0_2 * r0_2
        r0_8 = r0_2 * r0_2 * r0_2 * r0_2
        den6_inv = 1.0 / (r6 + r0_6)
        den8_inv = 1.0 / (r8 + r0_8)
        damp_sum = s6 * den6_inv + s8 * r4r2_ij * den8_inv

        e_ij = -c6 * damp_sum
        r5 = r4 * r_safe
        r7 = r6 * r_safe
        dd6 = -6.0 * s6 * r5 * den6_inv * den6_inv
        dd8 = -8.0 * s8 * r4r2_ij * r7 * den8_inv * den8_inv
        de_dr = -c6 * (dd6 + dd8)

        t = jnp.clip((r_safe - s5_on) * inv_w, 0.0, 1.0)
        t2 = t * t
        t3 = t2 * t
        t4 = t3 * t
        s5v = 10.0 * t3 - 15.0 * t4 + 6.0 * t4 * t
        ds5 = (-30.0 * t2 + 60.0 * t3 - 30.0 * t4) * inv_w
        disabled = s5_off <= s5_on
        sw = jnp.where(
            disabled | (r_safe <= s5_on), 1.0,
            jnp.where(r_safe >= s5_off, 0.0, 1.0 - s5v),
        )
        dsw = jnp.where(
            disabled | (r_safe <= s5_on) | (r_safe >= s5_off), 0.0, ds5
        )
        e_sw = e_ij * sw
        de_dr_sw = sw * de_dr + e_ij * dsw

        coef = jnp.where(pair_ok, de_dr_sw / r_safe, 0.0)
        fx = coef * dx
        fy = coef * dy
        fz = coef * dz

        e_masked = jnp.where(pair_ok, e_sw, 0.0)
        e_row = jnp.sum(e_masked, axis=1)
        if bidx is not None:
            e_sys = jax.ops.segment_sum(0.5 * e_row, bidx, num_segments=num_systems)
        else:
            e_sys = jnp.full((1,), 0.5 * jnp.sum(e_row), dtype=dtype)

        # switched dE/dCN (see dftd3.py module note on the reference's
        # unswitched accumulation)
        decn_row = jnp.sum(jnp.where(pair_ok, -damp_sum * sw * dc6_dcni, 0.0), axis=1)

        if compute_virial:
            comps = []
            for fa, da in ((fx, dx), (fy, dy), (fz, dz)):
                for _, db in ((fx, dx), (fy, dy), (fz, dz)):
                    comps.append(jnp.sum(fa * db, axis=1))
            v_rows = jnp.stack(comps, axis=-1).reshape(n, 3, 3)
            if bidx is not None:
                v_sys = jax.ops.segment_sum(-0.5 * v_rows, bidx, num_segments=num_systems)
            else:
                v_sys = -0.5 * jnp.sum(v_rows, axis=0, keepdims=True)
            vir_acc = vir_acc + v_sys

        return (
            e_acc + e_sys,
            fx_a + jnp.sum(fx, axis=1),
            fy_a + jnp.sum(fy, axis=1),
            fz_a + jnp.sum(fz, axis=1),
            decn_acc + decn_row,
            vir_acc,
        ), None

    init2 = (
        jnp.zeros((num_systems,), dtype=dtype),
        jnp.zeros((n,), dtype=dtype),
        jnp.zeros((n,), dtype=dtype),
        jnp.zeros((n,), dtype=dtype),
        jnp.zeros((n,), dtype=dtype),
        jnp.zeros((num_systems, 3, 3), dtype=dtype),
    )
    (energy, fx_d, fy_d, fz_d, de_dcn, virial), _ = jax.lax.scan(
        direct_body, init2, starts
    )

    # ---- Pass 3: CN chain-rule forces -------------------------------------
    def chain_body(carry, c):
        fx_a, fy_a, fz_a, vir_acc = carry
        nm_c, sh_c = slice_chunk(c)
        valid, j, dx, dy, dz, r, r_safe = _geometry(
            pxyz, numbers, nm_c, sh_c, cr, bidx, fill_value, periodic
        )
        rcov_ij = rcov_i[:, None] + rcov[numbers[j]]
        rr = rcov_ij / r_safe
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rr - 1.0)))
        dcn_dr = -f_cn * (1.0 - f_cn) * k1 * rr / r_safe
        de_chain = (de_dcn[:, None] + de_dcn[j]) * dcn_dr
        coef = jnp.where(valid, de_chain / r_safe, 0.0)
        fx = coef * dx
        fy = coef * dy
        fz = coef * dz
        if compute_virial:
            comps = []
            for fa in (fx, fy, fz):
                for db in (dx, dy, dz):
                    comps.append(jnp.sum(fa * db, axis=1))
            v_rows = jnp.stack(comps, axis=-1).reshape(n, 3, 3)
            if bidx is not None:
                v_sys = jax.ops.segment_sum(-0.5 * v_rows, bidx, num_segments=num_systems)
            else:
                v_sys = -0.5 * jnp.sum(v_rows, axis=0, keepdims=True)
            vir_acc = vir_acc + v_sys
        return (
            fx_a + jnp.sum(fx, axis=1),
            fy_a + jnp.sum(fy, axis=1),
            fz_a + jnp.sum(fz, axis=1),
            vir_acc,
        ), None

    (fx_t, fy_t, fz_t, virial), _ = jax.lax.scan(
        chain_body, (fx_d, fy_d, fz_d, virial), starts
    )
    forces = jnp.stack([fx_t, fy_t, fz_t], axis=-1)
    return energy, forces, coord_num, virial


@partial(
    jax.jit,
    static_argnames=(
        "periodic", "num_systems", "compute_virial", "chunk", "mesh"
    ),
)
def dftd3_list_kernel(
    positions,
    numbers,
    idx_i,
    idx_j,
    shifts_xyz,
    cell_b,
    batch_idx,
    rcov,
    r4r2,
    c6ab,
    cn_ref,
    a1,
    a2,
    s8,
    k1,
    k3,
    s6,
    s5_on,
    s5_off,
    periodic: bool,
    num_systems: int,
    compute_virial: bool,
    chunk: int = 8192,
    mesh: int = 5,
):
    """Native COO/CSR-ordered pair-list D3 pipeline (no matrix expansion).

    Counterpart of the reference's ``_nl`` kernel family
    (reference dftd3.py:1261-1640), which iterates CSR rows directly.  Here
    the pair list is swept in 1-D chunks of per-pair math with
    ``segment_sum`` accumulation (``idx_i`` is CSR-ordered, so segments are
    sorted) — memory is O(num_pairs), never O(N x max_row) padded, which is
    what makes this path worthwhile for dense pair lists at scale.

    ``shifts_xyz`` is a tuple of three float [P] arrays (cartesian-ready
    unit-shift components), or None when non-periodic.
    """
    n = positions.shape[0]
    n_pairs = idx_i.shape[0]
    dtype = positions.dtype
    numbers = numbers.astype(INDEX_DTYPE)
    bidx = batch_idx.astype(INDEX_DTYPE) if batch_idx is not None else None

    num_chunks = max(1, -(-n_pairs // chunk))
    p_pad = num_chunks * chunk

    def pad1(a, fill=0):
        return jnp.pad(a, (0, p_pad - n_pairs), constant_values=fill)

    ii = pad1(idx_i.astype(INDEX_DTYPE))
    jj = pad1(idx_j.astype(INDEX_DTYPE))
    pair_live = jnp.arange(p_pad) < n_pairs
    if periodic:
        sxf = pad1(shifts_xyz[0].astype(dtype))
        syf = pad1(shifts_xyz[1].astype(dtype))
        szf = pad1(shifts_xyz[2].astype(dtype))
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]

    zmax1 = c6ab.shape[0]
    m2 = mesh * mesh
    c6_flat = c6ab.reshape(-1)
    cnref_flat = cn_ref.reshape(-1)
    inv_w = jnp.where(s5_off > s5_on, 1.0 / jnp.maximum(s5_off - s5_on, 1e-30), 0.0)

    if periodic:
        if bidx is not None and cell_b.shape[0] > 1:
            cell_pair = cell_b[bidx[jnp.clip(ii, 0, n - 1)]]  # [P, 3, 3]
        else:
            cell_pair = None  # single shared cell: use cell_b[0]

    def slice_c(a, c):
        return jax.lax.dynamic_slice(a, (c,), (chunk,))

    def geom(c):
        i_c = slice_c(ii, c)
        j_c = slice_c(jj, c)
        live = slice_c(pair_live, c)
        i_cl = jnp.clip(i_c, 0, max(n - 1, 0))
        j_cl = jnp.clip(j_c, 0, max(n - 1, 0))
        valid = live & (numbers[i_cl] != 0) & (numbers[j_cl] != 0)
        dx = px[j_cl] - px[i_cl]
        dy = py[j_cl] - py[i_cl]
        dz = pz[j_cl] - pz[i_cl]
        if periodic:
            sx = slice_c(sxf, c)
            sy = slice_c(syf, c)
            sz = slice_c(szf, c)
            if cell_pair is not None:
                cp = jax.lax.dynamic_slice(
                    cell_pair, (c, jnp.zeros((), INDEX_DTYPE),
                                jnp.zeros((), INDEX_DTYPE)), (chunk, 3, 3)
                )
                dx = dx + sx * cp[:, 0, 0] + sy * cp[:, 1, 0] + sz * cp[:, 2, 0]
                dy = dy + sx * cp[:, 0, 1] + sy * cp[:, 1, 1] + sz * cp[:, 2, 1]
                dz = dz + sx * cp[:, 0, 2] + sy * cp[:, 1, 2] + sz * cp[:, 2, 2]
            else:
                cb = cell_b[0]
                dx = dx + sx * cb[0, 0] + sy * cb[1, 0] + sz * cb[2, 0]
                dy = dy + sx * cb[0, 1] + sy * cb[1, 1] + sz * cb[2, 1]
                dz = dz + sx * cb[0, 2] + sy * cb[1, 2] + sz * cb[2, 2]
        r2 = dx * dx + dy * dy + dz * dz
        r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0)) * (r2 > 0)
        valid &= r > 1e-12
        r_safe = jnp.where(valid, r, 1.0)
        return valid, i_cl, j_cl, dx, dy, dz, r_safe

    starts = jnp.arange(num_chunks, dtype=INDEX_DTYPE) * chunk
    seg = partial(
        jax.ops.segment_sum, num_segments=n, indices_are_sorted=True
    )

    # ---- Pass 1: coordination numbers ------------------------------------
    def cn_body(cn_acc, c):
        valid, i_cl, j_cl, _dx, _dy, _dz, r_safe = geom(c)
        rcov_ij = rcov[numbers[i_cl]] + rcov[numbers[j_cl]]
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rcov_ij / r_safe - 1.0)))
        return cn_acc + seg(jnp.where(valid, f_cn, 0.0), i_cl), None

    coord_num, _ = jax.lax.scan(cn_body, jnp.zeros((n,), dtype=dtype), starts)

    # ---- Pass 2: energy, direct forces, dE/dCN, virial --------------------
    def direct_body(carry, c):
        e_acc, f_acc, decn_acc, vir_acc = carry
        valid, i_cl, j_cl, dx, dy, dz, r_safe = geom(c)
        z_i = numbers[i_cl]
        z_j = numbers[j_cl]
        base_ij = (z_i * zmax1 + z_j) * m2
        base_ji = (z_j * zmax1 + z_i) * m2
        c6, dc6_dcni, _ = _c6_online(
            coord_num[i_cl], coord_num[j_cl], base_ij, base_ji,
            c6_flat, cnref_flat, k3, mesh,
        )
        pair_ok = valid & (c6 >= 1e-12)

        r4r2_ij = 3.0 * r4r2[z_i] * r4r2[z_j]
        r0 = a1 * jnp.sqrt(r4r2_ij) + a2
        r2_ = r_safe * r_safe
        r4 = r2_ * r2_
        r6 = r4 * r2_
        r8 = r4 * r4
        r0_2 = r0 * r0
        r0_6 = r0_2 * r0_2 * r0_2
        r0_8 = r0_2 * r0_2 * r0_2 * r0_2
        den6_inv = 1.0 / (r6 + r0_6)
        den8_inv = 1.0 / (r8 + r0_8)
        damp_sum = s6 * den6_inv + s8 * r4r2_ij * den8_inv
        e_ij = -c6 * damp_sum
        r5 = r4 * r_safe
        r7 = r6 * r_safe
        dd6 = -6.0 * s6 * r5 * den6_inv * den6_inv
        dd8 = -8.0 * s8 * r4r2_ij * r7 * den8_inv * den8_inv
        de_dr = -c6 * (dd6 + dd8)

        t = jnp.clip((r_safe - s5_on) * inv_w, 0.0, 1.0)
        t2 = t * t
        t3 = t2 * t
        t4 = t3 * t
        s5v = 10.0 * t3 - 15.0 * t4 + 6.0 * t4 * t
        ds5 = (-30.0 * t2 + 60.0 * t3 - 30.0 * t4) * inv_w
        disabled = s5_off <= s5_on
        sw = jnp.where(
            disabled | (r_safe <= s5_on), 1.0,
            jnp.where(r_safe >= s5_off, 0.0, 1.0 - s5v),
        )
        dsw = jnp.where(
            disabled | (r_safe <= s5_on) | (r_safe >= s5_off), 0.0, ds5
        )
        e_sw = e_ij * sw
        de_dr_sw = sw * de_dr + e_ij * dsw

        coef = jnp.where(pair_ok, de_dr_sw / r_safe, 0.0)
        fx = coef * dx
        fy = coef * dy
        fz = coef * dz
        e_masked = jnp.where(pair_ok, 0.5 * e_sw, 0.0)
        if bidx is not None:
            e_sys = jax.ops.segment_sum(
                e_masked, bidx[i_cl], num_segments=num_systems
            )
        else:
            e_sys = jnp.full((1,), jnp.sum(e_masked), dtype=dtype)
        decn = jnp.where(pair_ok, -damp_sum * sw * dc6_dcni, 0.0)
        f_new = f_acc + jnp.stack([seg(fx, i_cl), seg(fy, i_cl), seg(fz, i_cl)], -1)
        if compute_virial:
            comps = [jnp.where(pair_ok, fa * db, 0.0)
                     for fa in (fx, fy, fz) for db in (dx, dy, dz)]
            v_pairs = jnp.stack(comps, axis=-1)  # [chunk, 9]
            if bidx is not None:
                v_sys = jax.ops.segment_sum(
                    -0.5 * v_pairs, bidx[i_cl], num_segments=num_systems
                )
            else:
                v_sys = -0.5 * jnp.sum(v_pairs, axis=0, keepdims=True)
            vir_acc = vir_acc + v_sys.reshape(num_systems, 3, 3)
        return (e_acc + e_sys, f_new, decn_acc + seg(decn, i_cl), vir_acc), None

    init2 = (
        jnp.zeros((num_systems,), dtype=dtype),
        jnp.zeros((n, 3), dtype=dtype),
        jnp.zeros((n,), dtype=dtype),
        jnp.zeros((num_systems, 3, 3), dtype=dtype),
    )
    (energy, forces, de_dcn, virial), _ = jax.lax.scan(direct_body, init2, starts)

    # ---- Pass 3: CN chain-rule forces -------------------------------------
    def chain_body(carry, c):
        f_acc, vir_acc = carry
        valid, i_cl, j_cl, dx, dy, dz, r_safe = geom(c)
        rcov_ij = rcov[numbers[i_cl]] + rcov[numbers[j_cl]]
        rr = rcov_ij / r_safe
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rr - 1.0)))
        dcn_dr = -f_cn * (1.0 - f_cn) * k1 * rr / r_safe
        de_chain = (de_dcn[i_cl] + de_dcn[j_cl]) * dcn_dr
        coef = jnp.where(valid, de_chain / r_safe, 0.0)
        fx = coef * dx
        fy = coef * dy
        fz = coef * dz
        f_new = f_acc + jnp.stack([seg(fx, i_cl), seg(fy, i_cl), seg(fz, i_cl)], -1)
        if compute_virial:
            comps = [jnp.where(valid, fa * db, 0.0)
                     for fa in (fx, fy, fz) for db in (dx, dy, dz)]
            v_pairs = jnp.stack(comps, axis=-1)
            if bidx is not None:
                v_sys = jax.ops.segment_sum(
                    -0.5 * v_pairs, bidx[i_cl], num_segments=num_systems
                )
            else:
                v_sys = -0.5 * jnp.sum(v_pairs, axis=0, keepdims=True)
            vir_acc = vir_acc + v_sys.reshape(num_systems, 3, 3)
        return (f_new, vir_acc), None

    (forces, virial), _ = jax.lax.scan(chain_body, (forces, virial), starts)
    return energy, forces, coord_num, virial
