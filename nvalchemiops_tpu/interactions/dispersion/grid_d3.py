# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) on the halo atom grid — the at-scale path.

Same physics as ``dftd3.py`` (see its docstring for formulas and reference
citations), evaluated over ``nvalchemiops_tpu.grid.AtomGrid`` candidate
blocks so the hot loop contains no per-pair gathers and no per-pair
transcendentals:

- per-atom element data (rcov, r4r2, reference CNs, the atom's C6 row
  ``c6ab[z_i]``) is fetched once per atom and scattered into grid planes;
- the Gaussian 5x5 interpolation factorizes exactly over the reference grid
  (``exp(k3(di^2+dj^2)) = e_i e_j``), so the per-pair quantities are
  bilinear forms; the *feature planes* ``R_j[z*mesh+q] = [z==z_j] e_j[q]``
  are built ONCE per pass (flat, never materializing a ``[.., 17, 5]``
  trailing pair) and windowed by the sweep, leaving THREE batched
  matmuls per pair block (z, z_di, z_dj);
- the normalization ``w = e_i^T M01 e_j`` exploits that real D3 tables have
  a *separable* availability mask ``M01[zi,zj,p,q] = m[zi,p] m[zj,q]``
  (a reference compound either exists for an element or it doesn't), so
  w and its CN derivatives are rank-1: products of per-atom scalars —
  no matmul at all.  :func:`element_c6_mask` validates separability.
- per-atom ``e_i`` are max-scaled over the *masked* reference points (an
  exact LSE stabilization — the scales cancel in every ratio) and zeroed at
  nonexistent points so garbage ``cn_ref`` entries can neither overflow nor
  poison the interpolation.

Structural requirements (validated on the host, like the reference's own
format checks): element-structured ``cn_ref`` (:func:`element_cn_ref`) and
separable C6 availability.  Fully general tables use the matrix-path
``dftd3``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from nvalchemiops_tpu.types import INDEX_DTYPE
from nvalchemiops_tpu.grid import (
    AtomGrid,
    _extend_like,
    gather_from_grid,
    gather_rows_from_grid,
    grid_row_reduce_sym,
    row_home_mask,
    scatter_rows_to_grid,
    use_slot_gather,
    scatter_to_grid,
)

__all__ = ["compact_d3_elements", "element_cn_ref", "element_c6_mask",
           "grid_dftd3", "grid_dftd3_coulomb", "batch_grid_dftd3"]


def element_cn_ref(cn_ref, atol=0.0):
    """Extract the element-structured CN reference table [Zmax+1, mesh].

    Real D3 data satisfies ``cn_ref[zi, zj, p, q] == cnA[zi, p]`` for all
    non-padding partners ``zj >= 1``; raises if the provided table is not of
    that form (use the matrix-path ``dftd3`` for fully general tables).

    The ``zj == 0`` padding column is excluded from the check: the reference
    loader (reference examples/dispersion/utils.py:505-521 ``_build_arrays``)
    fills ``cn_ref`` rows only for partners 1..94, leaving the partner-0
    column at the -1.0 fill value.  Those entries are never used — every
    unavailable (p, q) point is masked out of the interpolation by the C6
    availability mask (:func:`element_c6_mask`), matching the reference
    kernels' ``c6 != 0`` guard (reference dftd3.py C6 interpolation).
    """
    cn_ref = np.asarray(jax.device_get(cn_ref))
    zmax1, _, mesh, _ = cn_ref.shape
    cand = cn_ref[:, 0, :, 0] if zmax1 == 1 else cn_ref[:, min(1, zmax1 - 1), :, 0]
    full = np.broadcast_to(cand[:, None, :, None], cn_ref.shape)
    chk = slice(min(1, zmax1 - 1), None)  # skip the zj=0 padding column
    if not np.allclose(full[:, chk], cn_ref[:, chk], atol=atol, rtol=0.0):
        raise ValueError(
            "cn_ref is not element-structured (cn_ref[zi, zj, p, q] must "
            "depend only on (zi, p) for zj >= 1); use the matrix-path "
            "dftd3 instead"
        )
    return jnp.asarray(cand)


def element_c6_mask(c6ab):
    """Per-element reference availability mask m [Zmax+1, mesh].

    Validates that the C6 zero pattern is separable,
    ``(c6ab != 0)[zi, zj, p, q] == m[zi, p] & m[zj, q]`` — true for real
    DFT-D3 parameter tables, where a reference compound either exists for
    an element or it doesn't.  Raises otherwise (matrix path handles the
    general case).
    """
    c6 = np.asarray(jax.device_get(c6ab))
    nz = c6 != 0.0
    m = nz.any(axis=(1, 3))  # [Z+1, mesh]
    sep = m[:, None, :, None] & m[None, :, None, :]
    # element 0 (padding) has an all-zero table; exclude it from the check
    sep[0] = False
    sep[:, 0] = False
    chk = nz.copy()
    chk[0] = False
    chk[:, 0] = False
    if not (chk == sep).all():
        raise ValueError(
            "c6ab zero pattern is not separable per element; use the "
            "matrix-path dftd3 instead"
        )
    return jnp.asarray(m.astype(c6.dtype))


def compact_d3_elements(numbers, rcov, r4r2, c6ab, cn_ref):
    """Remap atomic numbers onto the dense set of elements present.

    The grid/dense engines turn the 5x5 C6 interpolation into bilinear
    forms of width ``zm = (Zmax+1) * mesh`` — with full periodic
    tables (Z <= 94, zm = 475) pass 2 pays ~5x more matmul work than a
    typical composition needs.  This helper selects the elements actually
    present and relabels ``numbers`` with dense local indices (padding 0
    stays 0), shrinking every downstream feature width to
    ``(n_present+1) * mesh``.

    Host-side (``np.unique`` must see concrete values): call once per
    composition OUTSIDE jit and reuse across MD steps — the mapping only
    changes when the element set changes.  Accepts the full
    ``cn_ref [Z+1, Z+1, m, m]`` or the element-structured ``[Z+1, m]``
    form.  Returns ``(numbers_local, rcov_c, r4r2_c, c6ab_c, cn_ref_c)``.

    Reference counterpart: none — the reference's per-pair table gathers
    (dftd3.py:426-548) are composition-size-independent, so it never
    needs this; the bilinear formulation does.
    """
    numbers_np = np.asarray(jax.device_get(numbers))
    rcov_np = np.asarray(jax.device_get(rcov))
    r4r2_np = np.asarray(jax.device_get(r4r2))
    c6_np = np.asarray(jax.device_get(c6ab))
    cn_np = np.asarray(jax.device_get(cn_ref))
    present = np.unique(numbers_np)
    present = present[present > 0].astype(np.int64)
    if present.size and present.max() >= rcov_np.shape[0]:
        raise ValueError(
            f"atomic number {present.max()} exceeds table size "
            f"{rcov_np.shape[0]}"
        )
    lut = np.zeros(rcov_np.shape[0], np.int32)
    lut[present] = np.arange(1, present.size + 1, dtype=np.int32)
    sel = np.r_[np.zeros(1, np.int64), present]
    cn_c = cn_np[np.ix_(sel, sel)] if cn_np.ndim == 4 else cn_np[sel]
    return (
        jnp.asarray(lut[numbers_np]),
        jnp.asarray(rcov_np[sel]),
        jnp.asarray(r4r2_np[sel]),
        jnp.asarray(c6_np[np.ix_(sel, sel)]),
        jnp.asarray(cn_c),
    )


def make_d3_row_kernels(cutoff_sq, a1, a2, s6, s8, k1, k3, zm, upper,
                        precision=None, compute_virial=False,
                        bilinear: str = "stack"):
    """The three D3 pass bodies for [.., cap, W] row-window pair blocks.

    ``kern(carry, own, cand, home) -> (carry, j_deltas)`` matching the
    :func:`nvalchemiops_tpu.grid.grid_row_reduce_sym` contract; shared by
    the single-device XLA engine and the z-slab domain decomposition
    (parallel/domain.py), so the two stay numerically identical by
    construction.  Validity compares are absent — parked invalid slots
    (displacement validity) fail the distance test on their own.

    ``bilinear`` selects how pass 2 evaluates its three bilinear forms:

    - ``"stack"`` (default): zacc and z_di share the candidate ``rf``
      window (the fattest read of the pass); stacking their two small
      lhs operands on the row axis reads it once.  Bit-identical to
      split.
    - ``"split"``: three einsums [.., cap, zm] x [.., W, zm] (M=cap).
    - ``"quad"``: one dot of the stacked operands ([l0; l1] on the cap
      axis x [rf | rfd] on the window axis) -> [.., 2 cap, 2 W]; the
      three used quadrants are slices, the l1 x rfd quadrant is wasted
      work.  Bit-identical to split; never the default.

    With ``compute_virial`` the direct/chain carries gain a trailing
    ``[3, 3]`` virial accumulator: ``-sum_pairs F_pair (x) d`` (the
    matrix path's ``-1/2 sum`` over both directions equals one full sum
    over the pair-once enumeration).

    ``precision=None`` means ``HIGHEST`` (see :func:`grid_dftd3`).
    """
    if precision is None:
        precision = jax.lax.Precision.HIGHEST

    def _virial_acc(vir, blocks, ds):
        comps = [jnp.sum(fa * db) for fa in blocks for db in ds]
        return vir - jnp.stack(comps).reshape(3, 3)

    def geom(own, cand):
        # One rsqrt instead of sqrt + later divisions — every downstream
        # 1/r^k is assembled from inv_r products.
        dx = cand["px"][..., None, :] - own["px"][..., :, None]
        dy = cand["py"][..., None, :] - own["py"][..., :, None]
        dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < cutoff_sq) & (d2 > 1e-20)
        r2m = jnp.where(ok, d2, 1.0)
        inv_r = jax.lax.rsqrt(r2m)
        return ok, inv_r, r2m, dx, dy, dz

    def cn_kern(cn, own, cand, home):
        ok, inv_r, _r2, *_ = geom(own, cand)
        if home:
            ok &= upper
        rc = own["rcov"][..., :, None] + cand["rcov"][..., None, :]
        f = jnp.where(ok, 1.0 / (1.0 + jnp.exp(-k1 * (rc * inv_r - 1.0))), 0.0)
        return cn + jnp.sum(f, axis=-1), (jnp.sum(f, axis=-2),)

    def direct_kern(carry, own, cand, home):
        if compute_virial:
            e, fx_a, fy_a, fz_a, decn, vir = carry
        else:
            e, fx_a, fy_a, fz_a, decn = carry
        ok, inv_r, r2_, dx, dy, dz = geom(own, cand)
        if home:
            ok &= upper

        lf = own["lf"]
        l0 = lf[..., :zm]
        l1c = lf[..., zm:]
        # z_di/z_dj are the COMPENSATED bilinears (l1c/rfdc features):
        # z_di = z_di_naive - c6 w_di, z_dj = z_dj_naive - c6 w_dj — see
        # _d3_atom_features.
        if bilinear == "quad":
            cap_i = l0.shape[-2]
            w_j = cand["rf"].shape[-2]
            lhs = jnp.concatenate([l0, l1c], axis=-2)      # [.., 2 cap, zm]
            rhs = jnp.concatenate([cand["rf"], cand["rfdc"]],
                                  axis=-2)                 # [.., 2 W, zm]
            out = jnp.einsum("...if,...jf->...ij", lhs, rhs,
                             precision=precision)
            zacc = out[..., :cap_i, :w_j]
            z_di = out[..., cap_i:, :w_j]
            z_dj = out[..., :cap_i, w_j:]
        elif bilinear == "stack":
            # lhs-only merge: zacc and z_di share the SAME rhs window
            # (cand["rf"], the fattest read of the pass) — stacking the
            # two small lhs operands on the row axis reads it once and
            # costs no wasted quadrant (unlike "quad").
            cap_i = l0.shape[-2]
            pet = (jnp.float32 if l0.dtype == jnp.bfloat16 else None)
            out = jnp.einsum("...if,...jf->...ij",
                             jnp.concatenate([l0, l1c], axis=-2),
                             cand["rf"], precision=precision,
                             preferred_element_type=pet)
            zacc = out[..., :cap_i, :]
            z_di = out[..., cap_i:, :]
            z_dj = jnp.einsum("...if,...jf->...ij", l0, cand["rfdc"],
                              precision=precision,
                              preferred_element_type=pet)
        else:
            pet = (jnp.float32 if l0.dtype == jnp.bfloat16 else None)
            zacc = jnp.einsum("...if,...jf->...ij", l0, cand["rf"],
                              precision=precision,
                              preferred_element_type=pet)
            z_di = jnp.einsum("...if,...jf->...ij", l1c, cand["rf"],
                              precision=precision,
                              preferred_element_type=pet)
            z_dj = jnp.einsum("...if,...jf->...ij", l0, cand["rfdc"],
                              precision=precision,
                              preferred_element_type=pet)
        w = own["w"][..., :, None] * cand["w"][..., None, :]

        good = w > 1e-12
        w_inv = 1.0 / jnp.where(good, w, 1.0)
        c6 = jnp.where(good, zacc * w_inv, 0.0)

        pair_ok = ok & (c6 >= 1e-12)
        # si = sqrt(sqrt(3) r4r2) per atom: rr = (si_i si_j)^2, r0 needs no
        # per-slot sqrt
        t = own["si"][..., :, None] * cand["si"][..., None, :]
        rr = t * t
        r0 = a1 * t + a2
        r4 = r2_ * r2_
        r6 = r4 * r2_
        r8 = r4 * r4
        r0_2 = r0 * r0
        r0_6 = r0_2 * r0_2 * r0_2
        r0_8 = r0_6 * r0_2
        den6 = r6 + r0_6
        den8 = r8 + r0_8
        rec = 1.0 / (den6 * den8)          # one divide for both dampings
        den6_inv = rec * den8
        den8_inv = rec * den6
        damp_sum = s6 * den6_inv + s8 * rr * den8_inv

        e_ij = -c6 * damp_sum
        # (dE/dr)/r directly: dd6/r = -6 s6 r^4 den6^2, dd8/r = -8 s8 rr r^6 den8^2
        dd6 = -6.0 * s6 * r4 * den6_inv * den6_inv
        dd8 = -8.0 * s8 * rr * r6 * den8_inv * den8_inv

        coef = jnp.where(pair_ok, -c6 * (dd6 + dd8), 0.0)
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        # dei/dej = -damp (2 k3 / w)(z_d - c6 w_d): shared prefactor
        m = jnp.where(pair_ok, (-2.0 * k3) * damp_sum * w_inv, 0.0)
        e = e + jnp.sum(jnp.where(pair_ok, e_ij, 0.0), axis=-1)
        fx_a = fx_a + jnp.sum(cfx, axis=-1)
        fy_a = fy_a + jnp.sum(cfy, axis=-1)
        fz_a = fz_a + jnp.sum(cfz, axis=-1)
        decn = decn + jnp.sum(m * z_di, axis=-1)
        deltas = (
            -jnp.sum(cfx, axis=-2),
            -jnp.sum(cfy, axis=-2),
            -jnp.sum(cfz, axis=-2),
            jnp.sum(m * z_dj, axis=-2),
        )
        if compute_virial:
            vir = _virial_acc(vir, (cfx, cfy, cfz), (dx, dy, dz))
            return (e, fx_a, fy_a, fz_a, decn, vir), deltas
        return (e, fx_a, fy_a, fz_a, decn), deltas

    def chain_kern(carry, own, cand, home):
        if compute_virial:
            fx_a, fy_a, fz_a, vir = carry
        else:
            fx_a, fy_a, fz_a = carry
        ok, inv_r, _r2, dx, dy, dz = geom(own, cand)
        if home:
            ok &= upper
        rc = own["rcov"][..., :, None] + cand["rcov"][..., None, :]
        rrq = rc * inv_r
        f_cn = 1.0 / (1.0 + jnp.exp(-k1 * (rrq - 1.0)))
        # (dCN/dr)/r = -f(1-f) k1 rc / r^3
        dcn_dr_r = -f_cn * (1.0 - f_cn) * k1 * rrq * inv_r * inv_r
        de_chain = (own["decn"][..., :, None]
                    + cand["decn"][..., None, :]) * dcn_dr_r
        coef = jnp.where(ok, de_chain, 0.0)
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        fx_a = fx_a + jnp.sum(cfx, axis=-1)
        fy_a = fy_a + jnp.sum(cfy, axis=-1)
        fz_a = fz_a + jnp.sum(cfz, axis=-1)
        deltas = (
            -jnp.sum(cfx, axis=-2),
            -jnp.sum(cfy, axis=-2),
            -jnp.sum(cfz, axis=-2),
        )
        if compute_virial:
            vir = _virial_acc(vir, (cfx, cfy, cfz), (dx, dy, dz))
            return (fx_a, fy_a, fz_a, vir), deltas
        return (fx_a, fy_a, fz_a), deltas

    return cn_kern, direct_kern, chain_kern


def make_coulomb_row_kernel(coulomb_cutoff_sq: float, alpha: float, upper):
    """(Damped-)Coulomb pair body for [.., cap, W] row-window blocks.

    Same math as ``grid._coulomb_impl``'s kern; factored out so the fused
    D3+Coulomb pass (:func:`fuse_direct_kernels`) and the domain
    decomposition can ride one candidate window.  ``alpha``/``cutoff``
    are Python floats (static) so the undamped path never traces erfc.
    """
    from nvalchemiops_tpu.mathops.math import erfc_approx

    two_over_sqrt_pi = 1.1283791670955126
    alpha_t = float(alpha)
    ccut_sq = float(coulomb_cutoff_sq)

    def kern(carry, own, cand, home):
        e, fx, fy, fz = carry
        dx = cand["px"][..., None, :] - own["px"][..., :, None]
        dy = cand["py"][..., None, :] - own["py"][..., :, None]
        dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < ccut_sq) & (d2 > 1e-20)
        if home:
            ok &= upper
        inv_r = jax.lax.rsqrt(jnp.where(ok, d2, 1.0))
        qq = own["q"][..., :, None] * cand["q"][..., None, :]
        if alpha_t > 0:
            r = jnp.where(ok, d2, 1.0) * inv_r
            ar = alpha_t * r
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
        cfx = coef * dx
        cfy = coef * dy
        cfz = coef * dz
        e = e + jnp.sum(e_pair, axis=-1)
        fx = fx - jnp.sum(cfx, axis=-1)
        fy = fy - jnp.sum(cfy, axis=-1)
        fz = fz - jnp.sum(cfz, axis=-1)
        deltas = (
            jnp.sum(e_pair, axis=-2),
            jnp.sum(cfx, axis=-2),
            jnp.sum(cfy, axis=-2),
            jnp.sum(cfz, axis=-2),
        )
        return (e, fx, fy, fz), deltas

    return kern


def fuse_direct_kernels(direct_kern, coulomb_kern):
    """Run the D3 direct body and the Coulomb body on one candidate window.

    The two bodies recompute the displacement planes from the same
    ``own``/``cand`` inputs — XLA CSEs them, so geometry is materialized
    once per window while each body keeps its own cutoff/validity test.
    Carry/deltas are the concatenation (D3 first, Coulomb's 4 last).
    """

    def kern(carry, own, cand, home):
        d3_carry = carry[:-4]
        c_carry = carry[-4:]
        d3_carry2, d3_deltas = direct_kern(d3_carry, own, cand, home)
        c_carry2, c_deltas = coulomb_kern(c_carry, own, cand, home)
        return (tuple(d3_carry2) + tuple(c_carry2),
                tuple(d3_deltas) + tuple(c_deltas))

    return kern


def _d3_atom_features(numbers_a, cn_a, cna_a, mask_a, c6p_a, k3, dtype,
                      precision=None, extras: bool = False):
    """Per-atom C6-interpolation features (flat layouts).

    Returns ``(l0 [N, zm], l1c, rf [N, zm], rfdc, w [N], wd [N])``:

    - ``e_i[p] = m_i[p] exp(k3 (CN_i - cnA_i[p])^2 - masked_max)``: exact
      LSE scaling over *available* reference points; zeroed where
      unavailable so garbage cn_ref entries at nonexistent references
      cannot leak into any accumulator.
    - left features l0/l1 contract the own atom's C6 rows in advance;
      right features R[(z, q)] = [z == z_j] e_j[q] are built flat with
      constant one-hot expanders (never materializing a [.., Z, mesh]
      trailing pair).
    - the derivative features are COMPENSATED per atom: with
      ``a = wd/w``, ``l1c = l1 - a l0`` and ``rfdc = rfd - a rf`` so the
      pair kernels compute ``z_di - c6 w_di = l1c_i . rf_j`` and
      ``z_dj - c6 w_dj = l0_i . rfdc_j`` DIRECTLY.  The naive form is a
      catastrophic cancellation of two O(C6) bilinears — with
      reduced-precision matmul operands (bf16, TF32) it loses most of
      dE/dCN; the compensated form keeps the rounding relative to the
      small difference itself, and drops the w_di/w_dj products from
      the pair sweep.
    """
    mesh = cna_a.shape[-1]
    zm = c6p_a.shape[-1]
    zmax1 = zm // mesh

    d_vec = cn_a[..., None] - cna_a                       # [N, mesh]
    arg = k3 * d_vec * d_vec
    arg_m = jnp.where(mask_a > 0, arg, -jnp.inf)
    arg_max = jnp.maximum(jnp.max(arg_m, axis=-1, keepdims=True), -1e30)
    e_a = jnp.where(mask_a > 0, jnp.exp(arg - arg_max), 0.0)   # [N, mesh]
    ed_a = e_a * d_vec

    # scalar normalization features (rank-1 w): w_pair = wA_i * wA_j
    w_a = jnp.sum(e_a, axis=-1)                           # [N]
    wd_a = jnp.sum(ed_a, axis=-1)                         # [N]

    # compensated derivative weights, FACTORED as e (d - a) — never as
    # ed - a e or l1 - a l0: the post-contraction difference cancels two
    # O(C6 x CN) products whose exact cancellation XLA fusion breaks at
    # ulp scale.  In the saturated-CN regime (real tables: crystal CN
    # 7-17 vs a [0, 1] reference grid) that ulp noise is the ENTIRE
    # dE/dCN signal and is amplified to ~5e-3 f32 force error by the
    # chain pass, while d - a_cn == 0.0 bit-exactly at the dominant
    # reference under any fusion (a_cn = wd/w reduces to d there), so
    # the factored form is noise-free by construction (f32-vs-f64 force
    # error 4.7e-3 -> 1.6e-5 on the CsCl composite, CPU).
    a_cn = jnp.where(w_a > 0.0, wd_a / jnp.where(w_a > 0.0, w_a, 1.0), 0.0)
    edc_a = e_a * (d_vec - a_cn[..., None])

    # left features: l0[(z,q)] = sum_p c6[p, (z,q)] e[p]; l1c with edc.
    # c6p_a is p-major [N, mesh, zm] so each p-slice is contiguous.
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    l0_a = jnp.einsum("npf,np->nf", c6p_a, e_a, precision=precision)  # [N, zm]
    l1c_a = jnp.einsum("npf,np->nf", c6p_a, edc_a, precision=precision)

    # layout (z, q): column m = z*mesh + q.  R[(z,q)] = [z == z_j] e_j[q]
    # via repeat/tile — NOT one-hot expansion matmuls: a 0/1 selection
    # matmul at reduced precision still rounds the *values* it selects
    # (bf16 rounding of rf/rfd surfaced as 3e-2 force error).
    ziota = jax.lax.broadcasted_iota(INDEX_DTYPE, (1, zmax1), 1)
    ohz = (numbers_a[:, None] == ziota).astype(dtype)     # [N, Z+1]
    ohz_r = jnp.repeat(ohz, mesh, axis=-1)                # [N, zm]
    rf_a = ohz_r * jnp.tile(e_a, (1, zmax1))              # [N, zm]
    rfdc_a = ohz_r * jnp.tile(edc_a, (1, zmax1))

    if extras:
        # compact factorized right features for engines that rebuild
        # rf/rfdc in-kernel from [.., mesh] windows + the element id:
        # rf[(z, q)] = [z == z_j] e[q] and rfdc[(z, q)] = [z == z_j] edc[q]
        # (the compensation factorizes through the one-hot z mask)
        return l0_a, l1c_a, rf_a, rfdc_a, w_a, wd_a, e_a, edc_a
    return l0_a, l1c_a, rf_a, rfdc_a, w_a, wd_a


def _d3_feature_planes(grid, z_plane, cn_a, cna_a, mask_a, c6p_a, k3, dtype,
                       dims, cap, precision=None, numbers_a=None):
    """Per-atom C6-interpolation features scattered into grid planes.

    Returns ``(lf_plane [.., cap, 2 zm] = [l0 | l1c], rf_plane
    [.., cap, zm], rfdc_plane, w_a [N], wd_a [N])``; see
    :func:`_d3_atom_features` for the compensated l1c/rfdc features.
    ``numbers_a`` skips the plane regather when the caller already holds
    the per-atom numbers (saves one N-length gather).
    """
    from nvalchemiops_tpu.grid import _interior

    cz, cy, cx = dims
    if numbers_a is None:
        numbers_a = gather_from_grid(grid, z_plane)
    l0_a, l1_a, rf_a, rfd_a, w_a, wd_a = _d3_atom_features(
        numbers_a, cn_a, cna_a, mask_a, c6p_a, k3, dtype, precision)

    def feat_plane(vals):
        # slot -> atom row gather at scale (empty slots hit the zero fill
        # row), atom -> slot row scatter for small/slack-heavy systems —
        # see grid.use_slot_gather for the crossover
        nslots = cz * cy * cx * cap
        if use_slot_gather(vals.shape[0], nslots):
            padded = jnp.concatenate(
                [vals, jnp.zeros((1, vals.shape[-1]), dtype)], axis=0)
            aid = _interior(grid, grid.ext_aid).reshape(-1)
            return padded[aid].reshape(cz, cy, cx, cap, vals.shape[-1])
        buf = jnp.zeros((nslots + 1, vals.shape[-1]), dtype)
        return buf.at[grid.flat_slot].set(vals)[:-1].reshape(
            cz, cy, cx, cap, vals.shape[-1])

    lf_plane = feat_plane(jnp.concatenate([l0_a, l1_a], axis=-1))
    rf_plane = feat_plane(rf_a)
    rfd_plane = feat_plane(rfd_a)
    return lf_plane, rf_plane, rfd_plane, w_a, wd_a


@partial(
    jax.jit,
    static_argnames=("dims", "radius", "cap", "mesh", "zmax1", "precision",
                     "compute_virial", "skip_chain", "bilinear",
                     "feature_dtype", "coulomb_alpha", "coulomb_cutoff"),
)
def _grid_d3_impl(
    grid: AtomGrid,
    z_plane, z_ext,
    rcov_plane, rcov_ext,
    r4r2_plane, r4r2_ext,
    cna_a,                        # [N, mesh] per-atom reference CNs
    mask_a,                       # [N, mesh] per-atom availability mask
    c6p_a,                        # [N, mesh, zmax1*mesh] per-atom C6, p-major
    cutoff, a1, a2, s6, s8, k1, k3,
    dims, radius, cap, mesh: int, zmax1: int, precision=None,
    compute_virial: bool = False,
    cn_a_override=None, skip_chain: bool = False, bilinear: str = "split",
    numbers_a=None, feature_dtype=None,
    q_plane=None, q_ext=None, coulomb_alpha=None, coulomb_cutoff=None,
):
    """Row-sweep D3 pipeline.

    ``cn_a_override`` replaces pass 1 with precomputed per-atom CNs and
    ``skip_chain`` stops after pass 2 (returning the dE/dCN plane instead
    of chain forces) — together they let the hybrid engine run passes 1
    and 3 on the voxel stencil (stencil.py) while keeping the
    interpolation pass here.
    """
    dtype = grid.ext_px.dtype
    cz, cy, cx = dims
    rz_, ry_, rx_ = radius
    cutoff_sq = jnp.asarray(cutoff, dtype=dtype) ** 2

    # Padding atoms (numbers == 0) get parked like the build's empty slots
    # (displacement-based validity): the shadowed "px" planes below replace
    # the grid's own in the sweep and every validity compare disappears
    # from the pair bodies.
    from nvalchemiops_tpu.grid import DISPLACE, DISPLACE_SPACING, _interior
    ez_, ey_, ex_ = cz + 2 * rz_, cy + 2 * ry_, cx + 2 * rx_
    ext_iota = jnp.arange(ez_ * ey_ * ex_ * cap, dtype=dtype).reshape(
        ez_, ey_, ex_, cap)
    ext_px_d = grid.ext_px + jnp.where(
        z_ext == 0, DISPLACE + ext_iota * DISPLACE_SPACING, 0.0)

    # ---- pass 1: coordination numbers (symmetric row sweep) --------------
    upper = row_home_mask(cap, radius[2])
    zm = zmax1 * mesh
    cn_kern, direct_kern, chain_kern = make_d3_row_kernels(
        cutoff_sq, a1, a2, s6, s8, k1, k3, zm, upper, precision,
        compute_virial=compute_virial, bilinear=bilinear)

    extra_ext = (("px", ext_px_d), ("rcov", rcov_ext))
    extra_own = (("px", _interior(grid, ext_px_d)), ("rcov", rcov_plane))
    if cn_a_override is None:
        with jax.named_scope("d3.pass1_cn"):
            cn_plane, (cn_fold,) = grid_row_reduce_sym(
                grid, cn_kern, jnp.zeros((cz, cy, cx, cap), dtype), 1,
                extra_ext_planes=extra_ext, extra_own_planes=extra_own,
            )
            cn_plane = cn_plane + cn_fold
            cn_a = gather_from_grid(grid, cn_plane)  # [N]
    else:
        cn_a = cn_a_override
        # the caller already holds per-atom CNs; scattering them to a
        # plane only to gather them back out costs two N-ops
        cn_plane = None

    # ---- per-atom interpolation features (built ONCE, flat layouts) ------
    #
    # e_i[p] = m_i[p] exp(k3 (CN_i - cnA_i[p])^2 - masked_max): exact LSE
    # scaling over *available* reference points; zeroed where unavailable so
    # garbage cn_ref entries at nonexistent references cannot overflow or
    # leak into any accumulator (c6 rows are 0 there; w excludes them).
    with jax.named_scope("d3.features"):
        (lf_plane, rf_plane, rfdc_plane, w_a, wd_a) = _d3_feature_planes(
            grid, z_plane, cn_a, cna_a, mask_a, c6p_a, k3, dtype,
            dims, cap, precision, numbers_a=numbers_a,
        )
    if feature_dtype is not None:
        # einsum-operand-only storage cast: storing the features bf16
        # halves the windowed reads, the fattest memory traffic of
        # pass 2, at the cost of re-rounding the einsum operands
        lf_plane = lf_plane.astype(feature_dtype)
        rf_plane = rf_plane.astype(feature_dtype)
        rfdc_plane = rfdc_plane.astype(feature_dtype)
    rf_ext = _extend_like(grid, rf_plane, 0.0)
    rfdc_ext = _extend_like(grid, rfdc_plane, 0.0)
    w_plane = scatter_to_grid(grid, w_a)
    w_ext = _extend_like(grid, w_plane, 0.0)

    # ---- pass 2: energy, direct forces, dE/dCN ---------------------------
    zeros = jnp.zeros((cz, cy, cx, cap), dtype)
    vir0 = jnp.zeros((3, 3), dtype)
    si_plane = jnp.sqrt(r4r2_plane * 1.7320508075688772)
    si_ext = jnp.sqrt(r4r2_ext * 1.7320508075688772)
    extra_ext2 = extra_ext + (
        ("si", si_ext), ("rf", rf_ext), ("rfdc", rfdc_ext),
        ("w", w_ext),
    )
    extra_own2 = extra_own + (
        ("si", si_plane), ("lf", lf_plane),
        ("w", w_plane),
    )
    init2 = (zeros, zeros, zeros, zeros, zeros)
    if compute_virial:
        init2 = init2 + (vir0,)
    with_coulomb = coulomb_cutoff is not None
    pass2_kern = direct_kern
    num_acc2 = 4
    if with_coulomb:
        # real-space Coulomb rides the same candidate windows (one sweep
        # for the whole real-space force field; geometry CSEd by XLA)
        pass2_kern = fuse_direct_kernels(
            direct_kern,
            make_coulomb_row_kernel(float(coulomb_cutoff) ** 2,
                                    float(coulomb_alpha), upper))
        init2 = init2 + (zeros, zeros, zeros, zeros)
        num_acc2 = 8
        extra_ext2 = extra_ext2 + (("q", q_ext),)
        extra_own2 = extra_own2 + (("q", q_plane),)
    with jax.named_scope("d3.pass2_direct"):
        carry2, deltas2 = grid_row_reduce_sym(
            grid, pass2_kern, init2, num_acc2,
            extra_ext_planes=extra_ext2, extra_own_planes=extra_own2,
        )
    dfx, dfy, dfz, ddecn = deltas2[:4]
    e_pl, fx_pl, fy_pl, fz_pl, decn_pl = carry2[:5]
    vir = carry2[5] if compute_virial else None
    coul = None
    if with_coulomb:
        # the Coulomb kern's j-deltas carry the +cfx orientation (j-side
        # force is opposite the own-side subtraction), folded additively
        # exactly like grid._coulomb_impl
        dec, dfcx, dfcy, dfcz = deltas2[4:]
        ec, fcx, fcy, fcz = carry2[-4:]
        coul = (ec + dec, fcx + dfcx, fcy + dfcy, fcz + dfcz)
    fx_pl = fx_pl + dfx
    fy_pl = fy_pl + dfy
    fz_pl = fz_pl + dfz
    decn_pl = decn_pl + ddecn
    if skip_chain:
        out = (e_pl, fx_pl, fy_pl, fz_pl, cn_plane, decn_pl)
        return out + coul if with_coulomb else out
    decn_ext = _extend_like(grid, decn_pl, 0.0)

    # ---- pass 3: CN chain-rule forces (symmetric) --------------------------
    extra_ext3 = extra_ext + (("decn", decn_ext),)
    extra_own3 = extra_own + (("decn", decn_pl),)
    init3 = (fx_pl, fy_pl, fz_pl)
    if compute_virial:
        init3 = init3 + (vir,)
    with jax.named_scope("d3.pass3_chain"):
        carry3, (dfx3, dfy3, dfz3) = grid_row_reduce_sym(
            grid, chain_kern, init3, 3,
            extra_ext_planes=extra_ext3, extra_own_planes=extra_own3,
        )
    fx2 = carry3[0] + dfx3
    fy2 = carry3[1] + dfy3
    fz2 = carry3[2] + dfz3
    if compute_virial:
        out = (e_pl, fx2, fy2, fz2, cn_plane, carry3[3])
    else:
        out = (e_pl, fx2, fy2, fz2, cn_plane)
    return out + coul if with_coulomb else out


def grid_dftd3(
    grid: AtomGrid,
    numbers,
    rcov,
    r4r2,
    c6ab,
    cn_ref_elem,
    cutoff: float,
    a1, a2, s8,
    s6=1.0, k1=16.0, k3=-4.0,
    precision=None,
    engine: str | None = None,
    compute_virial: bool = False,
    stencil=None,
    bilinear: str = "stack",
    feature_dtype=None,
    hybrid_cn: str = "stencil",
):
    """DFT-D3(BJ) energies/forces/CNs on the atom grid.

    ``cn_ref_elem`` is the [Zmax+1, mesh] element-structured CN reference
    table (see :func:`element_cn_ref`); the C6 availability mask must be
    separable (see :func:`element_c6_mask`).  Returns
    ``(energy_total, forces [N,3], coord_num [N])`` in the grid's dtype.

    ``precision`` is the matmul precision of the C6-interpolation
    einsums; ``None`` (default) means ``HIGHEST``, full-f32 products.  A
    GPU may run ``Precision.DEFAULT`` float32 einsums in TF32, which moved
    the 109,744-atom CsCl composite's D3 energy 1.7e-4 relative to
    float64 on an H100 (against 1.5e-7 for full f32); pass it explicitly
    to trade that accuracy for speed.

    ``bilinear``: ``"stack"`` (default; lhs-stacked: the two einsums
    sharing the candidate ``rf`` window merge into one — same dot
    products, the fattest window read once; bit-identical to split),
    ``"split"`` (three einsums), or ``"quad"`` (one quadrant dot, kept
    for comparison).  ``feature_dtype=jnp.bfloat16`` stores the einsum
    feature planes in bf16, halving the windowed reads at the cost of
    re-rounding the einsum operands.

    ``engine`` selects the sweep implementation:

    - ``"xla"`` (default): the symmetric row sweep; traced parameters,
      precision/virial support.
    - ``"hybrid"`` (implied by passing ``stencil=``): the chain-rule
      pass (and, with ``hybrid_cn="stencil"``, the CN pass) runs on the
      capacity-free voxel stencil (stencil.py — requires a valid
      occupancy-1 ``StencilGrid`` built for >= this cutoff) while the
      C6-interpolation pass stays on the row sweep.
      ``hybrid_cn="row"`` keeps pass 1 on the row sweep too.

    Any other ``engine`` raises ``ValueError``.  Note the dC6/dCN chain
    is a near-cancellation: ~1e-6 CN rounding differences amplify to
    ~1e-4 *absolute* force noise on weak-force atoms in every engine and
    precision mode.

    ``compute_virial`` appends a ``[3, 3]`` virial (same contract as the
    matrix path's per-system virial, single system), computed on the
    row sweep's scan carries (a stencil, if given, is not used).
    """
    if engine not in (None, "xla", "hybrid"):
        raise ValueError(
            f"unknown grid_dftd3 engine {engine!r}; expected 'xla' or "
            "'hybrid'")
    dtype = grid.ext_px.dtype
    numbers = jnp.asarray(numbers, INDEX_DTYPE)
    zmax1 = rcov.shape[0]
    mesh = cn_ref_elem.shape[1]
    mask_elem = element_c6_mask(c6ab)

    # per-atom element data (cheap N-length gathers)
    rcov_a = rcov.astype(dtype)[numbers]
    r4r2_a = r4r2.astype(dtype)[numbers]
    cna_a = cn_ref_elem.astype(dtype)[numbers]                  # [N, mesh]
    mask_a = mask_elem.astype(dtype)[numbers]                   # [N, mesh]
    # p-major per-atom C6 rows: [N, mesh(p), zmax1*mesh(z,q)]
    c6p = jnp.transpose(c6ab.astype(dtype), (0, 2, 1, 3)).reshape(
        zmax1, mesh, zmax1 * mesh
    )
    c6p_a = c6p[numbers]

    zf_plane, rcov_plane, r4r2_plane = scatter_rows_to_grid(
        grid, (numbers.astype(dtype), rcov_a, r4r2_a))
    z_plane = zf_plane.astype(INDEX_DTYPE)
    z_ext = _extend_like(grid, z_plane, 0)
    rcov_ext = _extend_like(grid, rcov_plane, 0.0)
    r4r2_ext = _extend_like(grid, r4r2_plane, 0.0)

    if compute_virial:
        # the virial lives on the row sweep's scan carries
        engine = "xla"
        stencil = None
    if engine is None:
        engine = "xla" if stencil is None else "hybrid"
    if engine == "hybrid" and stencil is None:
        raise ValueError("engine='hybrid' requires a StencilGrid (stencil=...)")
    chain_forces_a = None
    if engine == "hybrid":
        # passes 1 and 3 on the capacity-free voxel stencil; pass 2 (the
        # C6-interpolation sweep) on the row grid
        from nvalchemiops_tpu.stencil import (
            extend_stencil,
            scatter_to_stencil,
            stencil_cn_chain_forces,
            stencil_coordination_numbers,
        )

        # rcov planes scattered once, shared by the CN and chain sweeps
        rcov_int = scatter_to_stencil(stencil, rcov_a)
        rcov_planes = (rcov_int, extend_stencil(stencil, rcov_int, 0.0))
        if hybrid_cn == "stencil":
            cn_a = stencil_coordination_numbers(
                stencil, rcov_a, float(cutoff), float(k1),
                rcov_planes=rcov_planes)
            cn_override = cn_a
        else:  # "row": pass 1 stays on the row sweep
            cn_override = None
        e_pl, fx_pl, fy_pl, fz_pl, cn_pl, decn_pl = _grid_d3_impl(
            grid,
            z_plane, z_ext,
            rcov_plane, rcov_ext,
            r4r2_plane, r4r2_ext,
            cna_a, mask_a, c6p_a,
            jnp.asarray(cutoff, dtype), jnp.asarray(a1, dtype),
            jnp.asarray(a2, dtype), jnp.asarray(s6, dtype),
            jnp.asarray(s8, dtype), jnp.asarray(k1, dtype),
            jnp.asarray(k3, dtype),
            grid.dims, grid.radius, grid.cap, int(mesh), int(zmax1),
            precision, compute_virial=False,
            cn_a_override=cn_override, skip_chain=True, numbers_a=numbers,
            bilinear=bilinear, feature_dtype=feature_dtype,
        )
        decn_a = gather_from_grid(grid, decn_pl)
        chain_forces_a = stencil_cn_chain_forces(
            stencil, rcov_a, decn_a, float(cutoff), float(k1),
            rcov_planes=rcov_planes)
    else:
        out = _grid_d3_impl(
            grid,
            z_plane, z_ext,
            rcov_plane, rcov_ext,
            r4r2_plane, r4r2_ext,
            cna_a, mask_a, c6p_a,
            jnp.asarray(cutoff, dtype), jnp.asarray(a1, dtype), jnp.asarray(a2, dtype),
            jnp.asarray(s6, dtype), jnp.asarray(s8, dtype), jnp.asarray(k1, dtype),
            jnp.asarray(k3, dtype),
            grid.dims, grid.radius, grid.cap, int(mesh), int(zmax1),
            precision, compute_virial=compute_virial, numbers_a=numbers,
            bilinear=bilinear, feature_dtype=feature_dtype,
        )
        e_pl, fx_pl, fy_pl, fz_pl, cn_pl = out[:5]
        if compute_virial:
            virial = out[5]
    energy = jnp.sum(e_pl)  # pairs counted once in the symmetric sweep
    if cn_pl is None:
        # hybrid: CNs never left atom-major form (stencil pass 1)
        f1, f2, f3 = gather_rows_from_grid(grid, (fx_pl, fy_pl, fz_pl))
        coord_num = cn_a
    else:
        f1, f2, f3, coord_num = gather_rows_from_grid(
            grid, (fx_pl, fy_pl, fz_pl, cn_pl))
    forces = jnp.stack([f1, f2, f3], axis=-1)
    if chain_forces_a is not None:
        forces = forces + chain_forces_a
    if compute_virial:
        return energy, forces, coord_num, virial
    return energy, forces, coord_num


def grid_dftd3_coulomb(
    grid: AtomGrid,
    numbers,
    charges,
    rcov,
    r4r2,
    c6ab,
    cn_ref_elem,
    cutoff: float,
    a1, a2, s8,
    coulomb_cutoff: float | None = None,
    alpha: float = 0.0,
    s6=1.0, k1=16.0, k3=-4.0,
    engine: str = "xla",
    combine_forces: bool = False,
):
    """Fused DFT-D3(BJ) + real-space (erfc-damped) Coulomb on one sweep.

    The MLIP real-space workload in a single pass: the Coulomb pair terms
    ride the D3 direct pass's geometry on the row sweep (``engine="xla"``,
    the only engine; any other name raises ``ValueError``), saving a full
    second sweep over all candidate pairs.  Both cutoffs must be <= the
    cutoff the grid was built for.

    Returns ``(e_d3_total, f_d3 [N,3], coord_num [N],
    e_coulomb [N], f_coulomb [N,3])``; energy/force channels are kept
    separate so callers can scale them independently.  With
    ``combine_forces`` the force entry carries D3 + Coulomb combined
    and the trailing ``f_coulomb`` is ``None``:
    ``(e_d3_total, f_total, coord_num, e_coulomb, None)``.
    """
    if engine != "xla":
        raise ValueError(
            f"unknown grid_dftd3_coulomb engine {engine!r}; expected 'xla'")
    dtype = grid.ext_px.dtype
    numbers = jnp.asarray(numbers, INDEX_DTYPE)
    zmax1 = rcov.shape[0]
    mesh = cn_ref_elem.shape[1]
    mask_elem = element_c6_mask(c6ab)
    if coulomb_cutoff is None:
        coulomb_cutoff = cutoff

    rcov_a = rcov.astype(dtype)[numbers]
    r4r2_a = r4r2.astype(dtype)[numbers]
    cna_a = cn_ref_elem.astype(dtype)[numbers]
    mask_a = mask_elem.astype(dtype)[numbers]
    c6p = jnp.transpose(c6ab.astype(dtype), (0, 2, 1, 3)).reshape(
        zmax1, mesh, zmax1 * mesh
    )
    c6p_a = c6p[numbers]

    zf_plane, rcov_plane, r4r2_plane, q_plane = scatter_rows_to_grid(
        grid, (numbers.astype(dtype), rcov_a, r4r2_a,
               jnp.asarray(charges, dtype)))
    z_plane = zf_plane.astype(INDEX_DTYPE)
    z_ext = _extend_like(grid, z_plane, 0)
    rcov_ext = _extend_like(grid, rcov_plane, 0.0)
    r4r2_ext = _extend_like(grid, r4r2_plane, 0.0)
    q_ext = _extend_like(grid, q_plane, 0.0)

    (e_pl, fx_pl, fy_pl, fz_pl, cn_pl,
     ec_pl, fcx_pl, fcy_pl, fcz_pl) = _grid_d3_impl(
        grid,
        z_plane, z_ext,
        rcov_plane, rcov_ext,
        r4r2_plane, r4r2_ext,
        cna_a, mask_a, c6p_a,
        jnp.asarray(cutoff, dtype), jnp.asarray(a1, dtype),
        jnp.asarray(a2, dtype), jnp.asarray(s6, dtype),
        jnp.asarray(s8, dtype), jnp.asarray(k1, dtype),
        jnp.asarray(k3, dtype),
        grid.dims, grid.radius, grid.cap, int(mesh), int(zmax1),
        numbers_a=numbers,
        q_plane=q_plane, q_ext=q_ext,
        coulomb_alpha=float(alpha),
        coulomb_cutoff=float(coulomb_cutoff),
    )
    energy = jnp.sum(e_pl)
    f1, f2, f3, coord_num, e_c, fc1, fc2, fc3 = gather_rows_from_grid(
        grid, (fx_pl, fy_pl, fz_pl, cn_pl, ec_pl, fcx_pl, fcy_pl, fcz_pl))
    forces = jnp.stack([f1, f2, f3], axis=-1)
    f_c = jnp.stack([fc1, fc2, fc3], axis=-1)
    if combine_forces:
        return energy, forces + f_c, coord_num, e_c, None
    return energy, forces, coord_num, e_c, f_c


def batch_grid_dftd3(
    positions,
    numbers,
    cells,
    pbc,
    cutoff: float,
    rcov,
    r4r2,
    c6ab,
    cn_ref_elem,
    a1, a2, s8,
    s6=1.0, k1=16.0, k3=-4.0,
    target_occupancy: float = 0.66,
    cap: int | None = None,
    engine: str = "xla",
):
    """Batched DFT-D3(BJ) on a fused whole-batch halo grid.

    The grid counterpart of the reference's batched D3
    (dispersion/dftd3.py batch path; benchmark config 128 x 2000 atoms):
    systems share one static grid geometry (dims/radius/capacity sized
    from ``cells[0]``), the batch grid is built by ONE fused
    compound-key sort (``grid.batch_build_atom_grid`` — a vmapped
    per-system build loses the sort/histogram/sorted-gather lowerings),
    and the 3-pass sweep maps over the leading
    system axis — XLA batches every plane op and einsum, which is
    exactly the reference's "many systems on one device" scaling story.

    ``positions`` [B, n, 3], ``numbers`` [B, n] (0 = padding atom),
    ``cells`` [3, 3] shared or [B, 3, 3] (must share the grid geometry of
    ``cells[0]``).  Returns ``(energy [B], forces [B, n, 3], cn [B, n])``.
    """
    from nvalchemiops_tpu.grid import (
        batch_build_atom_grid, estimate_grid_geometry,
    )

    positions = jnp.asarray(positions)
    b, n = positions.shape[0], positions.shape[1]
    cells = jnp.asarray(cells, positions.dtype)
    shared_cell = cells.ndim == 2
    cell0 = cells if shared_cell else cells[0]
    dims, radius, cap_est = estimate_grid_geometry(
        cell0, pbc, cutoff, n, target_occupancy=target_occupancy)
    if cap is None:
        cap = cap_est

    cn_ref_elem = jnp.asarray(cn_ref_elem)

    g_b = batch_build_atom_grid(positions, cells, pbc, dims, radius, cap)
    return jax.vmap(
        lambda g, z: grid_dftd3(g, z, rcov, r4r2, c6ab, cn_ref_elem, cutoff,
                                a1, a2, s8, s6=s6, k1=k1, k3=k3,
                                engine=engine)
    )(g_b, numbers)
