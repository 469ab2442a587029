# SPDX-License-Identifier: Apache-2.0
"""GPU smoke test: the NL + D3 + Coulomb + PME composite at full size.

Runs in one process on one GPU:

- phase 0: require a GPU and print what it is;
- phase 1: the headline composite through the public entry points with
  default engines — a 109,744-atom CsCl supercell (f32), grid build at a
  9.6 A cutoff, DFT-D3(BJ) energies/forces/CNs, erfc-damped real-space
  Coulomb and PME reciprocal space on a 128^3 mesh with forces — timing
  each stage (first call = compile + run, then steady state) and its peak
  device memory;
- phase 2: the plain float64 reference at the same size on the GPU: the
  cell-list neighbor matrix (its per-atom counts must equal the grid's),
  matrix-path ``dftd3``, neighbor-matrix ``coulomb_energy_forces`` and
  float64 PME at ``precision="highest"``, each compared with phase 1;
- phase 3: the batched paths at the reference's matched sizes
  (``batch_dftd3`` on 128 x 2,000 atoms at 21.2 A, ``batch_pme_reciprocal``
  on 64 x 2,000 atoms at 32^3), each checked on two of its systems against
  the single-system float64 matrix path.

``--gpus 4`` instead runs only the four-GPU paths (z-slab domain
decomposition of the composite, the sharded MLIP training step and the
batch-sharded PME) and compares each with its single-device result.

Every comparison is gated; any failure raises and the process exits
non-zero.  The last line of standard output is one JSON object naming the
device.  On a machine without a GPU the script exits non-zero before
computing anything.

Usage::

    python chip_smoke.py            # one GPU
    python chip_smoke.py --gpus 4   # four GPUs of one host
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.composite_accuracy import (  # noqa: E402
    A_LAT, D3_A1, D3_A2, D3_S8, build_system,
)
from benchmarks.harness import configure_compile_cache  # noqa: E402
from nvalchemiops_tpu.grid import (  # noqa: E402
    build_atom_grid,
    choose_grid_geometry,
    grid_coulomb_energy_forces,
    grid_neighbor_count,
)
from nvalchemiops_tpu.interactions.dispersion import (  # noqa: E402
    D3Parameters,
    dftd3,
)
from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (  # noqa: E402
    compact_d3_elements,
    grid_dftd3,
)
from nvalchemiops_tpu.interactions.electrostatics import (  # noqa: E402
    coulomb_energy_forces,
)
from nvalchemiops_tpu.interactions.electrostatics.pme import (  # noqa: E402
    pme_reciprocal_space,
)
from nvalchemiops_tpu.neighborlist import neighbor_list  # noqa: E402

N_REP = 38            # 2 * 38^3 = 109,744 atoms, box 156.7 A
CUTOFF = 9.6          # real-space cutoff (sits in a shell gap of the crystal)
ALPHA = 0.35          # Ewald splitting parameter, 1/A
MESH = (128, 128, 128)
BATCH_D3 = (128, 10, 21.2)      # systems, n_rep (2,000 atoms), cutoff
BATCH_PME = (64, 10, (32, 32, 32), 0.35)  # systems, n_rep, mesh, alpha

# Tolerances (f32 result against the f64 plain reference).
#
# Coulomb and PME: every operation is a sum of well-conditioned pair or
# mesh terms, so f32 rounding bounds the error; the library's CPU audit
# lands at 2e-6-2e-5 relative (README), and these gates are the CPU's.
# Scale-relative max force error = max|f - f_ref| / max|f_ref|.
COUL_F_MAX_REL = 1e-4
COUL_E_REL = 1e-5
PME_F_MAX_REL = 1e-4
PME_E_REL = 1e-5
# D3: the dC6/dCN chain rule amplifies f32 rounding of the coordination
# numbers on a few weak-force atoms (benchmarks/composite_accuracy.py
# relative_errors), so the max error carries a conditioning floor the RMS
# does not.  The energy is a sum of same-signed pair terms (~1e-7 on the
# CPU); CNs are sums of ~100 logistic terms of size ~0.1.
D3_F_MAX_REL = 2e-3
D3_F_RMS_REL = 2e-4
D3_E_REL = 1e-5
D3_CN_ABS = 1e-4
# Multi-device paths against the same f32 computation on one device: the
# arithmetic is identical up to reduction order.
SHARD_F_MAX_REL = 1e-4
SHARD_E_REL = 1e-5


class GateError(AssertionError):
    """A comparison exceeded its stated tolerance."""


class Gates:
    """The comparisons of one phase: print each, raise once all are shown."""

    def __init__(self):
        self.failed = []

    def check(self, label, value, limit):
        ok = value <= limit
        print(f"[check] {label}: {value:.3e} (limit {limit:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(f"{label} = {value:.3e} exceeds {limit:.0e}")

    def close(self):
        if self.failed:
            raise GateError("; ".join(self.failed))


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(label, fn, *args, repeats=3):
    """Run ``fn(*args)`` once cold and ``repeats`` times warm; print times.

    Host clock around ``block_until_ready``; the first call includes
    tracing and compilation.  Returns the last output.
    """
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        steady.append(time.perf_counter() - t0)
    print(f"[time] {label}: first {first * 1e3:.3f} ms, steady median "
          f"{np.median(steady) * 1e3:.3f} ms (min {min(steady) * 1e3:.3f}, "
          f"n={repeats}), peak_bytes_in_use {peak_bytes()}", flush=True)
    return out


def rel_errors(f, f_ref):
    """(scale-relative max, RMS-relative) force errors."""
    f = np.asarray(f, np.float64)
    f_ref = np.asarray(f_ref, np.float64)
    diff = f - f_ref
    max_rel = float(np.abs(diff).max() / np.abs(f_ref).max())
    rms_rel = float(np.sqrt((diff ** 2).mean() / (f_ref ** 2).mean()))
    return max_rel, rms_rel


def f64_of_f32(x):
    """The f32 input the device computation saw, widened to float64.

    The references take the f32-rounded positions and cell, so a
    comparison measures the f32 arithmetic and not the rounding of the
    inputs (which alone moves PME forces by ~3e-5 of their scale here).
    """
    return jnp.asarray(np.asarray(x, np.float32), jnp.float64)


def energy_rel(e, e_ref):
    e = float(np.sum(np.asarray(e, np.float64)))
    e_ref = float(np.sum(np.asarray(e_ref, np.float64)))
    return abs(e - e_ref) / abs(e_ref)


# ---------------------------------------------------------------------------
# systems
# ---------------------------------------------------------------------------


def composite_system(n_rep):
    """CsCl supercell with the real Cs/Cl D3 tables, compacted (host)."""
    pos, cell, numbers, charges, rcov, r4r2, cna, c6 = build_system(
        n_rep=n_rep)
    numbers, rcov, r4r2, c6, cna = (
        np.asarray(a) for a in compact_d3_elements(numbers, rcov, r4r2, c6,
                                                   cna))
    return dict(pos=pos, cell=cell, numbers=numbers, charges=charges,
                rcov=rcov, r4r2=r4r2, c6=c6, cna=cna)


def cscl_batch(n_systems, n_rep, seed):
    """``n_systems`` independently jittered CsCl boxes, 2 n_rep^3 atoms each."""
    base = composite_system(n_rep)
    rng = np.random.default_rng(seed)
    lattice = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                       -1).reshape(-1, 3) * A_LAT
    lattice = np.concatenate([lattice, lattice + 0.5 * A_LAT], axis=0)
    pos = lattice[None] + rng.uniform(-0.1, 0.1, (n_systems,) + lattice.shape)
    return dict(base, pos=pos)


def d3_params_f64(s):
    """Matrix-path tables from the compacted element-structured tables."""
    cna = s["cna"]
    cn_ref = np.broadcast_to(cna[:, None, :, None],
                             (cna.shape[0],) * 2 + (cna.shape[1],) * 2)
    return D3Parameters(rcov=s["rcov"], r4r2=s["r4r2"], c6ab=s["c6"],
                        cn_ref=np.ascontiguousarray(cn_ref))


# ---------------------------------------------------------------------------
# phase 1: the composite
# ---------------------------------------------------------------------------


def run_composite(s, cutoff=CUTOFF, alpha=ALPHA, mesh=MESH, repeats=3):
    """Grid build + D3 + Coulomb + PME in f32 through the public entries."""
    dtype = jnp.float32
    pos = jnp.asarray(s["pos"], dtype)
    cell = jnp.asarray(s["cell"], dtype)
    pbc = np.array([True] * 3)
    charges = jnp.asarray(s["charges"], dtype)
    numbers = jnp.asarray(s["numbers"])
    tables = tuple(jnp.asarray(s[k], dtype)
                   for k in ("rcov", "r4r2", "c6", "cna"))

    t0 = time.perf_counter()
    dims, radius, cap, origin_np = choose_grid_geometry(pos, cell, pbc,
                                                        cutoff)
    print(f"[time] geometry search: {(time.perf_counter() - t0) * 1e3:.3f} ms"
          f" -> dims {dims} radius {radius} cap {cap}", flush=True)
    origin = None if origin_np is None else jnp.asarray(origin_np, dtype)

    def build(p):
        return build_atom_grid(p, cell, pbc, dims, radius, cap, origin=origin)

    def d3(g):
        return grid_dftd3(g, numbers, *tables, cutoff, D3_A1, D3_A2, D3_S8)

    def d3_tf32(g):
        return grid_dftd3(g, numbers, *tables, cutoff, D3_A1, D3_A2, D3_S8,
                          precision=jax.lax.Precision.DEFAULT)

    def coulomb(g):
        return grid_coulomb_energy_forces(g, charges, cutoff, alpha)

    def pme(p):
        return pme_reciprocal_space(p, charges, cell, alpha,
                                    mesh_dimensions=mesh, compute_forces=True)

    grid = timed("grid build", build, pos, repeats=repeats)
    if int(grid.counts_max) > cap:
        raise GateError(f"grid overflow: {int(grid.counts_max)} > cap {cap}")
    out = dict(grid=grid)
    out["d3"] = timed("grid D3 (E, F, CN)", d3, grid, repeats=repeats)
    out["d3_tf32"] = timed("grid D3 at Precision.DEFAULT", d3_tf32, grid,
                           repeats=repeats)
    out["coulomb"] = timed("grid Coulomb (E, F)", coulomb, grid,
                           repeats=repeats)
    out["pme"] = timed(f"PME reciprocal {mesh} (E, F)", pme, pos,
                       repeats=repeats)
    for name in ("d3", "coulomb", "pme"):
        for a in jax.tree_util.tree_leaves(out[name]):
            if not np.isfinite(np.asarray(a)).all():
                raise GateError(f"non-finite {name} output")
    return out


# ---------------------------------------------------------------------------
# phase 2: the float64 plain reference at the same size
# ---------------------------------------------------------------------------


def check_against_reference(s, out, cutoff=CUTOFF, alpha=ALPHA, mesh=MESH,
                            max_neighbors=160, repeats=3):
    """Compare phase-1 outputs with the f64 matrix paths; raise on a miss."""
    gates = Gates()
    n = s["pos"].shape[0]
    pbc = np.array([True] * 3)
    counts_grid = np.asarray(grid_neighbor_count(out["grid"], cutoff, n))
    with jax.enable_x64(True):
        pos = f64_of_f32(s["pos"])
        cell = f64_of_f32(s["cell"])
        q = f64_of_f32(s["charges"])
        t0 = time.perf_counter()
        nm, num, shifts = jax.block_until_ready(neighbor_list(
            pos, cutoff, cell=cell, pbc=pbc, method="cell_list",
            max_neighbors=max_neighbors))
        print(f"[time] f64 cell-list neighbor matrix (first call): "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        num = np.asarray(num)
        if num.max() > max_neighbors:
            raise GateError(f"neighbor matrix overflow: {num.max()}")
        mismatched = int((num != counts_grid).sum())
        print(f"[check] neighbor counts: {mismatched} of {n} atoms differ "
              f"(mean {num.mean():.3f}, max {num.max()})", flush=True)
        if mismatched:
            raise GateError(f"{mismatched} atoms: cell-list count != grid")

        params = d3_params_f64(s)
        numbers = jnp.asarray(s["numbers"])

        def d3_matrix(p, c):
            return dftd3(p, numbers, D3_A1, D3_A2, D3_S8, d3_params=params,
                         cell=c, neighbor_matrix=nm,
                         neighbor_matrix_shifts=shifts, output_dtype=None)

        e_ref, f_ref, cn_ref = timed("matrix-path D3 f64 (E, F, CN)",
                                     d3_matrix, pos, cell, repeats=1)
        e_c_ref, f_c_ref = coulomb_energy_forces(
            pos, q, cell, cutoff, alpha, neighbor_matrix=nm,
            neighbor_matrix_shifts=shifts)
        with jax.default_matmul_precision("highest"):
            e_p_ref, f_p_ref = pme_reciprocal_space(
                pos, q, cell, alpha, mesh_dimensions=mesh,
                compute_forces=True)

    # the original's formulation at the composite's precision, for timing
    timed("matrix-path D3 f32 (E, F, CN)", d3_matrix,
          jnp.asarray(s["pos"], jnp.float32),
          jnp.asarray(s["cell"], jnp.float32), repeats=repeats)

    e_d3, f_d3, cn_d3 = out["d3"]
    f_max, f_rms = rel_errors(f_d3, f_ref)
    gates.check("D3 energy rel", energy_rel(e_d3, e_ref), D3_E_REL)
    gates.check("D3 force max-rel", f_max, D3_F_MAX_REL)
    gates.check("D3 force rms-rel", f_rms, D3_F_RMS_REL)
    gates.check("D3 CN max-abs",
                float(np.abs(np.asarray(cn_d3, np.float64)
                             - np.asarray(cn_ref)).max()), D3_CN_ABS)
    e_c, f_c = out["coulomb"]
    gates.check("Coulomb energy rel", energy_rel(e_c, e_c_ref), COUL_E_REL)
    gates.check("Coulomb force max-rel", rel_errors(f_c, f_c_ref)[0],
                COUL_F_MAX_REL)
    e_p, f_p = out["pme"]
    gates.check("PME energy rel", energy_rel(e_p, e_p_ref), PME_E_REL)
    gates.check("PME force max-rel", rel_errors(f_p, f_p_ref)[0],
                PME_F_MAX_REL)
    e_t, f_t, _ = out["d3_tf32"]
    print(f"[report] D3 at Precision.DEFAULT (not gated): energy rel "
          f"{energy_rel(e_t, e_ref):.3e}, force max-rel / rms-rel "
          "{:.3e} / {:.3e}".format(*rel_errors(f_t, f_ref)), flush=True)
    gates.close()


# ---------------------------------------------------------------------------
# phase 3: batched paths at the reference's matched sizes
# ---------------------------------------------------------------------------


def check_batch_d3(n_systems, n_rep, cutoff, check=(0, -1), repeats=3):
    from nvalchemiops_tpu.interactions.dispersion.dense_d3 import batch_dftd3

    gates = Gates()
    s = cscl_batch(n_systems, n_rep, seed=1)
    n = s["pos"].shape[1]
    pos = jnp.asarray(s["pos"], jnp.float32)
    cell = jnp.asarray(s["cell"], jnp.float32)
    numbers = jnp.asarray(np.broadcast_to(s["numbers"], (n_systems, n)))
    tables = tuple(jnp.asarray(s[k], jnp.float32)
                   for k in ("rcov", "r4r2", "c6", "cna"))

    def run(p):
        return batch_dftd3(p, numbers, cell, np.array([True] * 3), cutoff,
                           *tables, D3_A1, D3_A2, D3_S8)

    e_b, f_b, cn_b = timed(f"batch_dftd3 {n_systems} x {n} @ {cutoff} A",
                           run, pos, repeats=repeats)
    params = d3_params_f64(s)
    for b in check:
        with jax.enable_x64(True):
            p64 = f64_of_f32(s["pos"][b])
            c64 = f64_of_f32(s["cell"])
            nm, num, sh = neighbor_list(p64, cutoff, cell=c64,
                                        pbc=np.array([True] * 3),
                                        method="cell_list",
                                        max_neighbors=1536)
            if int(np.asarray(num).max()) > 1536:
                raise GateError("batch D3 reference neighbor overflow")
            e_r, f_r, cn_r = dftd3(
                p64, jnp.asarray(s["numbers"]), D3_A1, D3_A2, D3_S8,
                d3_params=params, cell=c64, neighbor_matrix=nm,
                neighbor_matrix_shifts=sh, output_dtype=None)
        f_max, f_rms = rel_errors(f_b[b], f_r)
        gates.check(f"batch D3 [{b}] energy rel", energy_rel(e_b[b], e_r),
                    D3_E_REL)
        gates.check(f"batch D3 [{b}] force max-rel", f_max, D3_F_MAX_REL)
        gates.check(f"batch D3 [{b}] force rms-rel", f_rms, D3_F_RMS_REL)
        gates.check(f"batch D3 [{b}] CN max-abs",
                    float(np.abs(np.asarray(cn_b[b], np.float64)
                                 - np.asarray(cn_r)).max()), D3_CN_ABS)
    gates.close()


def check_batch_pme(n_systems, n_rep, mesh, alpha, check=(0, -1), repeats=3):
    from nvalchemiops_tpu.interactions.electrostatics.pme import (
        batch_pme_reciprocal,
    )

    gates = Gates()
    s = cscl_batch(n_systems, n_rep, seed=2)
    n = s["pos"].shape[1]
    pos = jnp.asarray(s["pos"], jnp.float32)
    cell = jnp.asarray(s["cell"], jnp.float32)
    q = jnp.asarray(np.broadcast_to(s["charges"], (n_systems, n)),
                    jnp.float32)

    def run(p):
        return batch_pme_reciprocal(p, q, cell, alpha, mesh,
                                    compute_forces=True)

    e_b, f_b = timed(f"batch_pme_reciprocal {n_systems} x {n} @ {mesh}",
                     run, pos, repeats=repeats)
    for b in check:
        with jax.enable_x64(True), jax.default_matmul_precision("highest"):
            e_r, f_r = pme_reciprocal_space(
                f64_of_f32(s["pos"][b]), f64_of_f32(s["charges"]),
                f64_of_f32(s["cell"]), alpha,
                mesh_dimensions=mesh, compute_forces=True)
        gates.check(f"batch PME [{b}] energy rel", energy_rel(e_b[b], e_r),
                    PME_E_REL)
        gates.check(f"batch PME [{b}] force max-rel",
                    rel_errors(f_b[b], f_r)[0], PME_F_MAX_REL)
    gates.close()


# ---------------------------------------------------------------------------
# --gpus 4: the multi-device paths
# ---------------------------------------------------------------------------


def _on_all(arr, devices, label):
    placed = set(arr.sharding.device_set)
    print(f"[check] {label} lives on {len(placed)} devices", flush=True)
    if placed != set(devices):
        raise GateError(f"{label} on {len(placed)} of {len(devices)} devices")


def check_multi_device(devices, n_rep=N_REP, cutoff=CUTOFF, alpha=ALPHA,
                       mesh=MESH, batch_pme=BATCH_PME):
    """Domain-decomposed composite, sharded MLIP step and batch-sharded PME,
    each against the same computation on one device."""
    from jax.sharding import Mesh
    from nvalchemiops_tpu.grid import (
        choose_grid_origin, estimate_grid_geometry,
    )
    from nvalchemiops_tpu.interactions.electrostatics.pme import (
        batch_pme_reciprocal,
    )
    from nvalchemiops_tpu.parallel import (
        domain_coulomb_energy_forces,
        domain_dftd3,
        domain_pme_reciprocal,
        init_mlip_params,
        make_mesh,
        make_z_mesh,
        shard_batch,
        sharded_batch_pme_reciprocal,
        sharded_train_step,
        train_step,
    )
    from nvalchemiops_tpu.parallel.mlip import default_d3_tables

    gates = Gates()
    nd = len(devices)
    s = composite_system(n_rep)
    dtype = jnp.float32
    pos = jnp.asarray(s["pos"], dtype)
    cell = jnp.asarray(s["cell"], dtype)
    pbc = np.array([True] * 3)
    q = jnp.asarray(s["charges"], dtype)
    numbers = jnp.asarray(s["numbers"])
    tables = tuple(jnp.asarray(s[k], dtype)
                   for k in ("rcov", "r4r2", "c6", "cna"))
    n = pos.shape[0]
    # the z axis is what the slabs split: its cell count must divide by the
    # device count (cutoff-sized bins; origin and capacity from the data)
    dims, radius, _ = estimate_grid_geometry(cell, pbc, cutoff, n)
    if dims[0] % nd:
        raise GateError(f"grid z extent {dims[0]} does not split over {nd}")
    origin_np, occ = choose_grid_origin(pos, cell, pbc, dims)
    cap = int(np.ceil((occ + 1) / 8)) * 8
    grid = build_atom_grid(pos, cell, pbc, dims, radius, cap,
                           origin=jnp.asarray(origin_np, dtype))
    print(f"[info] {n} atoms, grid dims {dims} radius {radius} cap {cap}, "
          f"{dims[0] // nd} z cells per device", flush=True)
    zmesh = make_z_mesh(devices)

    e1, f1, _ = grid_dftd3(grid, numbers, *tables, cutoff, D3_A1, D3_A2,
                           D3_S8)
    ed, fd, _ = timed(f"domain D3 over {nd} devices",
                      lambda g: domain_dftd3(zmesh, g, numbers, *tables,
                                             cutoff, D3_A1, D3_A2, D3_S8,
                                             cell), grid)
    _on_all(fd, devices, "domain D3 forces")
    gates.check("domain D3 energy rel", energy_rel(ed, e1), SHARD_E_REL)
    gates.check("domain D3 force max-rel", rel_errors(fd, f1)[0],
                SHARD_F_MAX_REL)

    ec1, fc1 = grid_coulomb_energy_forces(grid, q, cutoff, alpha)
    ecd, fcd = timed(f"domain Coulomb over {nd} devices",
                     lambda g: domain_coulomb_energy_forces(
                         zmesh, g, q, cell, cutoff, alpha), grid)
    _on_all(fcd, devices, "domain Coulomb forces")
    gates.check("domain Coulomb energy rel", energy_rel(ecd, ec1),
                SHARD_E_REL)
    gates.check("domain Coulomb force max-rel", rel_errors(fcd, fc1)[0],
                SHARD_F_MAX_REL)

    ep1, fp1 = pme_reciprocal_space(pos, q, cell, alpha,
                                    mesh_dimensions=mesh, compute_forces=True)
    epd, fpd = timed(f"domain PME {mesh} over {nd} devices",
                     lambda p: domain_pme_reciprocal(
                         zmesh, p, q, cell, alpha, mesh,
                         compute_forces=True), pos)
    _on_all(fpd, devices, "domain PME forces")
    gates.check("domain PME energy rel", energy_rel(epd, ep1), SHARD_E_REL)
    gates.check("domain PME force max-rel", rel_errors(fpd, fp1)[0],
                SHARD_F_MAX_REL)

    # sharded MLIP training step on a ("dp", "sp") mesh
    mlip_mesh = make_mesh(devices)
    zmax = 4
    params = init_mlip_params(zmax, dtype)
    mtables = default_d3_tables(zmax, dtype=dtype)
    rng = np.random.default_rng(3)
    bsz, atoms, box = (4 * mlip_mesh.shape["dp"], 64 * mlip_mesh.shape["sp"],
                       6.0)
    batch = (
        jnp.asarray(rng.uniform(0, box, (bsz, atoms, 3)), dtype),
        jnp.asarray(rng.integers(1, zmax + 1, (bsz, atoms)), jnp.int32),
        jnp.asarray(np.tile(np.eye(3) * box, (bsz, 1, 1)), dtype),
        jnp.asarray(rng.normal(size=bsz), dtype),
        jnp.asarray(rng.normal(size=(bsz, atoms, 3)) * 0.01, dtype),
    )
    _, loss1 = jax.jit(train_step, static_argnums=(3,))(params, mtables,
                                                         batch, 2.9)
    step = sharded_train_step(mlip_mesh, cutoff=2.9)
    sharded = shard_batch(mlip_mesh, batch)
    _on_all(sharded[0], devices, "MLIP batch positions")
    with mlip_mesh:
        _, lossd = timed(f"sharded MLIP train step {dict(mlip_mesh.shape)}",
                         step, params, mtables, sharded)
    gates.check("sharded MLIP loss rel", energy_rel(lossd, loss1),
                SHARD_E_REL)

    # batch-sharded PME against the unsharded batch
    nb, nrep_b, bmesh_dims, balpha = batch_pme
    sb = cscl_batch(nb, nrep_b, seed=4)
    pb = jnp.asarray(sb["pos"], dtype)
    qb = jnp.asarray(np.broadcast_to(sb["charges"], pb.shape[:2]), dtype)
    cb = jnp.asarray(sb["cell"], dtype)
    e_b1, f_b1 = batch_pme_reciprocal(pb, qb, cb, balpha, bmesh_dims,
                                      compute_forces=True)
    bmesh = Mesh(np.asarray(devices), ("dp",))
    e_bd, f_bd = timed(f"sharded batch PME {nb} systems over {nd} devices",
                       lambda p: sharded_batch_pme_reciprocal(
                           bmesh, p, qb, cb, balpha, bmesh_dims,
                           compute_forces=True), pb)
    _on_all(f_bd, devices, "sharded batch PME forces")
    gates.check("sharded batch PME energy rel", energy_rel(e_bd, e_b1),
                SHARD_E_REL)
    gates.check("sharded batch PME force max-rel",
                rel_errors(f_bd, f_b1)[0], SHARD_F_MAX_REL)
    gates.close()


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def device_report():
    """Phase 0: the backend must be a GPU; print what it is."""
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX backend is {backend!r}",
              file=sys.stderr)
        sys.exit(2)
    import jaxlib

    dev = jax.devices()[0]
    print(f"[device] {dev.device_kind}, {len(jax.devices())} visible; jax "
          f"{jax.__version__}, jaxlib {jaxlib.__version__}", flush=True)
    print(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile "
          f"cache {configure_compile_cache()}", flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4 runs only the four-GPU paths")
    args = ap.parse_args(argv)

    device_report()
    smi = nvidia_smi_line()
    t_start = time.perf_counter()
    if args.gpus == 4:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            raise GateError(f"--gpus 4 needs 4 GPUs, found {len(devices)}")
        check_multi_device(devices)
    else:
        s = composite_system(N_REP)
        print(f"[phase 1] composite: {s['pos'].shape[0]} atoms", flush=True)
        out = run_composite(s)
        print("[phase 2] float64 plain reference", flush=True)
        check_against_reference(s, out)
        print("[phase 3] batched paths", flush=True)
        check_batch_d3(*BATCH_D3)
        check_batch_pme(*BATCH_PME)
    print(f"[done] wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
