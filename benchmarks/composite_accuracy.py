# SPDX-License-Identifier: Apache-2.0
"""Composite force-accuracy check for bench.py (f32 device vs f64 CPU).

Builds a small replica of the headline composite system and computes
DFT-D3 + real-space Coulomb + PME reciprocal forces; ``build_system`` also
makes the full-size composite for bench.py and chip_smoke.py.

Run as a script with ``ref`` to write the f64 CPU reference
(``benchmarks/data/bench_acc_ref.npz``); bench.py imports
:func:`compute_forces` to evaluate the same stages on the device in f32
and :func:`relative_errors` to fold ``force_max_rel_err`` into its JSON
detail (BASELINE's metric is speed AND force agreement).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_REP = 8  # 1,024 atoms — big enough to exercise every engine branch
A_LAT = 4.123  # CsCl conventional lattice constant, Angstrom
CUTOFF = 9.6
ALPHA = 0.35
MESH = (32, 32, 32)
ZMAX = 94
# The f64 reference is committed in-repo (keyed by REF_VERSION below) so a
# cold run never pays the ~13-min CPU rebuild.
REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "bench_acc_ref.npz")


def load_reference():
    """Load the f64 reference forces, preferring the committed npz.

    Returns the npz object or None if neither the in-repo file nor the
    /tmp cache matches REF_VERSION (caller should then rebuild via
    ``python benchmarks/composite_accuracy.py ref``).
    """
    for path in (REF_PATH,):
        try:
            cached = np.load(path)
            if str(cached["version"]) == REF_VERSION:
                return cached
        except Exception:  # noqa: BLE001 - unreadable/missing: try next
            continue
    return None


_AUTOANG = 0.52917726

# PBE-D3(BJ) damping parameters (published functional set), converted to
# the benchmark's Angstrom length unit: a1, s8 are dimensionless; a2 is a
# length (Bohr in the published set).
D3_A1 = 0.4289
D3_A2 = 4.4407 * _AUTOANG
D3_S8 = 0.7875


def build_system(n_rep=N_REP, seed=0):
    """CsCl (B2) supercell + the real-provenance Cs/Cl D3 tables.

    CsCl supercells are the reference's own benchmark crystal for both D3
    and PME (reference benchmarks/interactions/dispersion/
    benchmark_config.yaml `system_type: cscl`; electrostatics config
    likewise), so the composite measures the same workload shape: two
    species (Cs 55 / Cl 17) on interpenetrating simple-cubic lattices with
    alternating +-1 formal charges.

    D3 tables are the committed published-provenance slice
    (d3_data.realistic_test_tables — Pyykko-Atsumi rcov, the standard
    sqrt(Z)-scaled r4r2 table, Derevianko Cs2 / D3-paper Cl2 C6 limits,
    Casimir-Polder hetero combination; see the provenance tiers in
    d3_data.py), unit-converted from atomic units to the benchmark's
    Angstrom coordinates (rcov, r4r2 x autoang; C6 x autoang^6 — exact,
    energies come out in Hartree with Angstrom positions).  Conditioning notes
    that shaped the old synthetic tables still hold and are satisfied by
    the real data: CN lands where dC6/dCN is tame (here the crystal CN
    ~7-17 saturates the two-point reference grid, so dC6/dCN ~ 0), and
    the 9.6 A cutoff sits in a shell-free gap of the jittered crystal so
    the f32-vs-f64 metric measures engine fidelity, not boundary-pair
    flips.  The engines compact the tables to the present-element set
    (grid_d3.compact_d3_elements), exactly as an MD caller would.
    """
    from nvalchemiops_tpu.interactions.dispersion.d3_data import (
        realistic_test_tables,
    )
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        element_cn_ref,
    )

    rng = np.random.default_rng(seed)
    gpts = np.stack(
        np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"), -1
    ).reshape(-1, 3) * A_LAT
    pos = np.concatenate([gpts, gpts + 0.5 * A_LAT], axis=0)
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape)
    n = pos.shape[0]
    cell = np.eye(3) * (n_rep * A_LAT)
    numbers = np.r_[np.full(n // 2, 55), np.full(n // 2, 17)].astype(np.int32)
    charges = np.r_[np.ones(n // 2), -np.ones(n // 2)]

    tables = realistic_test_tables(np.float64)
    rcov = tables["rcov"] * _AUTOANG
    r4r2 = tables["r4r2"] * _AUTOANG
    c6 = tables["c6ab"] * _AUTOANG**6
    # element-structured reference-CN grid (dimensionless; -1 sentinels
    # mark unavailable points and are preserved by element_cn_ref)
    cna = np.asarray(element_cn_ref(tables["cn_ref"]))
    return pos, cell, numbers, charges, rcov, r4r2, cna, c6


def compute_forces(dtype, d3_kwargs=None, pme_kwargs=None, coul_kwargs=None):
    """Per-stage force arrays {d3, coulomb, pme} for the small composite."""
    import jax.numpy as jnp

    from nvalchemiops_tpu.grid import (
        build_atom_grid, choose_grid_origin, estimate_grid_geometry,
        grid_coulomb_energy_forces,
    )
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        compact_d3_elements, grid_dftd3,
    )
    from nvalchemiops_tpu.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )
    from nvalchemiops_tpu.spline_windowed import observed_tile_capacity

    pos_np, cell_np, numbers, charges, rcov, r4r2, cna, c6 = build_system()
    numbers, rcov, r4r2, c6, cna = (
        np.asarray(a) for a in compact_d3_elements(numbers, rcov, r4r2, c6, cna)
    )
    pbc = np.array([True] * 3)
    pos = jnp.asarray(pos_np, dtype)
    cell = jnp.asarray(cell_np, dtype)
    dims, radius, cap = estimate_grid_geometry(
        cell, pbc, CUTOFF, pos.shape[0], target_occupancy=0.75
    )
    origin_np, observed = choose_grid_origin(pos, cell, pbc, dims)
    origin = jnp.asarray(origin_np, dtype) if origin_np.any() else None
    cap = max(int(np.ceil((observed + 1) / 8)) * 8,
              int(np.ceil(observed * 1.02 / 8)) * 8)
    g = build_atom_grid(pos, cell, pbc, dims, radius, cap, origin=origin)

    _, f_d3, _ = grid_dftd3(
        g, jnp.asarray(numbers), jnp.asarray(rcov, dtype),
        jnp.asarray(r4r2, dtype), jnp.asarray(c6, dtype),
        jnp.asarray(cna, dtype), CUTOFF, D3_A1, D3_A2, D3_S8,
        **(d3_kwargs or {}),
    )
    _, f_c = grid_coulomb_energy_forces(g, jnp.asarray(charges, dtype),
                                        CUTOFF, ALPHA, **(coul_kwargs or {}))
    tile_cap = observed_tile_capacity(pos, cell, MESH)
    _, f_p = pme_reciprocal_space(
        pos, jnp.asarray(charges, dtype), cell, ALPHA, mesh_dimensions=MESH,
        compute_forces=True, tile_capacity=tile_cap, **(pme_kwargs or {}),
    )
    return {
        "d3": np.asarray(f_d3, np.float64),
        "coulomb": np.asarray(f_c, np.float64),
        "pme": np.asarray(f_p, np.float64),
    }


def relative_errors(forces, ref):
    """max |f - f_ref| / max |f_ref| per stage (scale-relative max error).

    Note the f32 D3 max error has an *intrinsic* floor of ~1e-2 on this
    metric: all engines (matrix, grid xla/block/window, bf16 features)
    measure the SAME value, engines agree to 5e-8 at f64, and the cause is
    f32 CN rounding (~5e-6 absolute) amplified through the C6(CN_i, CN_j)
    Gaussian-interpolant derivative on a handful of weak-force atoms —
    input-precision conditioning, not implementation error.  The RMS
    metric (:func:`rms_errors`) is the stable engine-fidelity signal.
    """
    out = {}
    for k, f in forces.items():
        scale = np.abs(ref[k]).max()
        out[k] = float(np.abs(f - ref[k]).max() / scale)
    return out


def rms_errors(forces, ref):
    """RMS |f - f_ref| / RMS |f_ref| per stage (scale-relative RMS error)."""
    out = {}
    for k, f in forces.items():
        scale = np.sqrt((np.asarray(ref[k]) ** 2).mean())
        out[k] = float(np.sqrt(((f - ref[k]) ** 2).mean()) / scale)
    return out


REF_VERSION = (f"cscl-v5-realtables:n_rep={N_REP}:cutoff={CUTOFF}:"
               f"alpha={ALPHA}:mesh={MESH}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "ref"
    if mode == "ref":
        # The f64 CPU reference is deterministic (fixed seed/params) but
        # expensive to rebuild (the CPU compile of the grid sweep alone is
        # ~13 min), so it is committed in-repo keyed by REF_VERSION and
        # only rebuilt here after a parameter change.
        if load_reference() is not None:
            print(f"cached (version {REF_VERSION})", flush=True)
            sys.exit(0)
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        forces = compute_forces(jnp.float64)
        os.makedirs(os.path.dirname(REF_PATH), exist_ok=True)
        np.savez(REF_PATH, version=REF_VERSION, **forces)
        print(f"wrote {REF_PATH}", flush=True)
    else:
        import jax.numpy as jnp

        forces = compute_forces(jnp.float32)
        ref = load_reference()
        for k, v in relative_errors(forces, ref).items():
            print(f"{k}: max rel force err {v:.3e}", flush=True)
