# SPDX-License-Identifier: Apache-2.0
"""Headline benchmark: NL + DFT-D3 + PME at ~100k atoms on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "us/atom", "vs_baseline": N}

Pipeline (BASELINE.json config #5 shape): a 109,744-atom CsCl (B2)
supercell — the reference's own benchmark crystal for D3 and PME — f32;
one halo-grid build at the 9.6 A interaction cutoff; DFT-D3(BJ) energies
+ analytical forces + CNs on the grid row sweep (tables compacted to the
present elements); erfc-damped real-space Coulomb energies + forces on
the same grid; PME reciprocal space (128^3 mesh, tile-windowed
spread/gather) energies + spline-derivative forces.  Every stage runs
with the library's default engines.  Cutoff note: the reference's
published D3 number was measured at 21.2 A; this composite uses an
MD-typical 9.6 A for the real-space stages, per the BASELINE.json
MLIP-step framing.  9.6 (not 9.0) keeps the cutoff inside a gap of the
CsCl shell structure so the f32-vs-f64 force-accuracy gate measures
engine fidelity rather than boundary pairs flipping across the sharp
cutoff (see benchmarks/composite_accuracy.py).

Baseline (H100, from BASELINE.md): cell-list NL 0.051 us/atom (131k),
DFT-D3 0.19 us/atom (85.7k), PME reciprocal 0.045 us/atom (128k batched)
=> 0.286 us/atom combined.  vs_baseline = ours / baseline (1.0 = parity,
lower = faster).  The headline sums exactly those three stages; the
real-space erfc Coulomb stage (not part of the reference composite) is
measured too and reported in detail with a with-coulomb composite.

Timing: each stage runs inside a jitted ``lax.fori_loop`` chain with a
data-dependent perturbation per iteration, timed by differencing two
loop lengths (see benchmarks/harness.py).

Budget: the whole script is wall-clock guarded (reference analogue: the
SIGALRM Timer guard, reference benchmarks/utils.py:35-74); if the alarm
fires, the partial result is printed and the process exits non-zero, as
it does when any stage fails.  Override with BENCH_BUDGET_S (default
1140 s); the f64 accuracy reference is committed in-repo
(benchmarks/data/bench_acc_ref.npz).
"""

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T0 = time.time()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1140"))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.harness import (  # noqa: E402
    configure_compile_cache, measure, perturb_positions,
)
from nvalchemiops_tpu.grid import (  # noqa: E402
    build_atom_grid,
    choose_grid_geometry,
    grid_coulomb_energy_forces,
)
from nvalchemiops_tpu.interactions.dispersion.grid_d3 import grid_dftd3  # noqa: E402
from nvalchemiops_tpu.interactions.electrostatics.pme import (  # noqa: E402
    pme_reciprocal_space,
)

BASELINE_US_PER_ATOM = 0.286  # H100 components: 0.051 (NL) + 0.19 (D3) + 0.045 (PME)

# Mutable bench state shared with the SIGALRM handler: the handler prints
# whatever headline is computable from the stages measured so far.
_STATE = {"result": None, "printed": False}


def _emit(result):
    if _STATE["printed"]:
        return
    _STATE["printed"] = True
    print(json.dumps(result), flush=True)


def _remaining():
    return BUDGET_S - (time.time() - T0)


def _on_alarm(signum, frame):  # noqa: ARG001
    res = _STATE["result"]
    if res is None:
        res = {
            "metric": "NL+D3+PME end-to-end — INCOMPLETE (budget hit)",
            "value": None,
            "unit": "us/atom",
            "vs_baseline": None,
        }
    else:
        res = dict(res)
        res["detail"] = dict(res.get("detail", {}))
        res["detail"]["budget_hit"] = True
    _emit(res)
    os._exit(1)


def main():
    from benchmarks.composite_accuracy import (
        D3_A1, D3_A2, D3_S8, build_system,
    )
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        compact_d3_elements,
    )

    configure_compile_cache()
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(int(BUDGET_S), 1))

    # CsCl (B2) supercell — the reference's own benchmark crystal (see
    # composite_accuracy.build_system).  n_rep=38 -> 109,744 atoms, box
    # 156.7 A.  BENCH_NREP overrides for smoke-testing at small sizes.
    n_rep = int(os.environ.get("BENCH_NREP", "38"))
    pos_np, cell_np, numbers_np, charges_np, rcov_np, r4r2_np, cna_np, c6_np = (
        build_system(n_rep=n_rep)
    )
    n = pos_np.shape[0]

    dtype = jnp.float32
    pos = jnp.asarray(pos_np, dtype)
    cell = jnp.asarray(cell_np, dtype)
    pbc = np.array([True] * 3)
    cutoff = 9.6
    alpha = 0.35
    mesh = (128, 128, 128) if n_rep >= 24 else (32, 32, 32)

    charges = jnp.asarray(charges_np, dtype)
    # compact the Z<=94 tables to the present-element set (zm 475 -> 15) —
    # host-side, once per composition, exactly as an MD caller would
    numbers, rcov, r4r2, c6, cna = compact_d3_elements(
        numbers_np, rcov_np, r4r2_np, c6_np, cna_np
    )
    rcov, r4r2, c6, cna = (a.astype(dtype) for a in (rcov, r4r2, c6, cna))

    # exact-score geometry search (dims x origin x capacity): for the CsCl
    # supercell the {floor-1} 16^3 binning beats the naive 17^3 by ~17% in
    # swept slots (occ 35 either way, but 1.2x fewer cells at 9.79 A bins)
    dims, radius, cap, origin_np = choose_grid_geometry(pos, cell, pbc, cutoff)
    origin = (jnp.asarray(origin_np, dtype)
              if origin_np is not None and np.asarray(origin_np).any() else None)

    dep = perturb_positions()

    # --- core stage 1: neighbor structure build -----------------------------
    t_nl = measure(
        lambda p: build_atom_grid(p, cell, pbc, dims, radius, cap, origin=origin),
        dep, (pos,), iters=8,
    )

    # --- core stage 2: DFT-D3 energies + forces + CN (incl. its grid reuse) -
    def d3_step(p):
        gg = build_atom_grid(p, cell, pbc, dims, radius, cap, origin=origin)
        return grid_dftd3(
            gg, numbers, rcov, r4r2, c6, cna, cutoff, D3_A1, D3_A2, D3_S8,
        )

    t_d3_total = measure(d3_step, dep, (pos,), iters=3)
    t_d3 = max(t_d3_total - t_nl, 0.0)

    # --- core stage 3: PME reciprocal (energies + forces) -------------------
    from nvalchemiops_tpu.spline_windowed import observed_tile_capacity

    tile_cap = observed_tile_capacity(pos, cell, mesh)

    def pme_step(p):
        return pme_reciprocal_space(
            p, charges, cell, alpha, mesh_dimensions=mesh,
            compute_forces=True, tile_capacity=tile_cap,
        )

    t_pme = measure(pme_step, dep, (pos,), iters=3)

    # headline is now computable — keep _STATE["result"] current from here
    # on so the SIGALRM guard always has a valid line to print
    total = t_nl + t_d3 + t_pme
    us_per_atom = total * 1e6 / n
    result = {
        "metric": ("NL+D3+PME end-to-end (109,744-atom CsCl, f32, "
                   f"energies+forces, {jax.devices()[0].device_kind})"),
        "value": round(us_per_atom, 4),
        "unit": "us/atom",
        "vs_baseline": round(us_per_atom / BASELINE_US_PER_ATOM, 3),
        "detail": {
            "atoms": n,
            "nl_build_ms": round(t_nl * 1e3, 3),
            "dftd3_ms": round(t_d3 * 1e3, 3),
            "pme_recip_forces_ms_128^3": round(t_pme * 1e3, 3),
            "baseline_us_per_atom_h100": BASELINE_US_PER_ATOM,
        },
    }
    _STATE["result"] = result

    # --- optional stage: real-space Coulomb on the same grid ----------------
    # (not part of the reference composite; reported in detail only)
    t_coul = None
    if _remaining() > 240:
        def coul_step(p):
            gg = build_atom_grid(p, cell, pbc, dims, radius, cap, origin=origin)
            return grid_coulomb_energy_forces(gg, charges, cutoff, alpha)

        t_coul = max(measure(coul_step, dep, (pos,), iters=3) - t_nl, 0.0)
        result["detail"]["coulomb_real_ms"] = round(t_coul * 1e3, 3)
        result["detail"]["with_coulomb_us_per_atom"] = round(
            (total + t_coul) * 1e6 / n, 4)

    # --- optional stage: composite force accuracy (f32 device vs f64 ref) ---
    # reference metric text is "us/atom ... force max|err| vs reference";
    # the f64 reference is committed in-repo.
    if _remaining() > 330:
        from benchmarks import composite_accuracy as ca

        ref = ca.load_reference()
        if ref is None:
            raise RuntimeError(
                "committed accuracy reference missing/version-mismatched; "
                "run: python benchmarks/composite_accuracy.py ref")
        f_f32 = ca.compute_forces(jnp.float32)
        result["detail"]["force_max_rel_err"] = {
            k: round(v, 8) for k, v in ca.relative_errors(f_f32, ref).items()}
        # RMS is the stable engine-fidelity signal; the f32 D3 *max* error
        # carries a CN-conditioning floor (composite_accuracy.relative_errors)
        result["detail"]["force_rms_rel_err"] = {
            k: round(v, 8) for k, v in ca.rms_errors(f_f32, ref).items()}

    # --- optional stage: fused MD step (one jitted program, one build) ------
    # one row sweep for D3 + Coulomb, then PME
    if _remaining() > 280:
        from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
            grid_dftd3_coulomb,
        )

        def md_step(p):
            gg = build_atom_grid(p, cell, pbc, dims, radius, cap, origin=origin)
            e_d3, f_rs, _, e_c, _ = grid_dftd3_coulomb(
                gg, numbers, charges, rcov, r4r2, c6, cna, cutoff,
                D3_A1, D3_A2, D3_S8, alpha=alpha, combine_forces=True,
            )
            e_p, f_p = pme_step(p)
            return e_d3 + jnp.sum(e_p) + jnp.sum(e_c), f_rs + f_p

        t_fused = measure(md_step, dep, (pos,), iters=3)
        result["detail"]["fused_md_step_ms"] = round(t_fused * 1e3, 3)

    result["detail"]["bench_wall_s"] = round(time.time() - T0, 1)
    signal.alarm(0)
    _emit(result)


if __name__ == "__main__":
    main()
