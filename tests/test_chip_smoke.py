# SPDX-License-Identifier: Apache-2.0
"""chip_smoke.py on the CPU: its gates at a small size, and its refusal to
run without a GPU; plus the shared compile-cache setting."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from benchmarks.harness import REPO_ROOT, configure_compile_cache

SMALL_MESH = (16, 16, 16)


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO_ROOT,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=REPO_ROOT, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_composite_matches_f64_reference_small():
    """Phases 1 and 2 at n_rep=4 (128 atoms; 9.6 A spans several images)."""
    s = cs.composite_system(4)
    out = cs.run_composite(s, mesh=SMALL_MESH, repeats=1)
    cs.check_against_reference(s, out, mesh=SMALL_MESH, repeats=1)


def test_batched_paths_match_f64_reference_small():
    """Phase 3 at two 128-atom systems (dense D3 with images, dense PME)."""
    cs.check_batch_d3(2, 4, 12.0, repeats=1)
    cs.check_batch_pme(2, 4, SMALL_MESH, 0.35, repeats=1)


def test_gates_raise_after_reporting_every_check(capsys):
    gates = cs.Gates()
    gates.check("within", 1e-6, 1e-5)
    gates.check("beyond", 2e-5, 1e-5)
    gates.check("later", 0.0, 1e-5)
    with pytest.raises(cs.GateError, match="beyond"):
        gates.close()
    assert "[check] later" in capsys.readouterr().out
    max_rel, rms_rel = cs.rel_errors([[1.0, 0.0]], [[2.0, 0.0]])
    assert max_rel == pytest.approx(0.5)
    assert rms_rel == pytest.approx(0.5)
    assert cs.energy_rel([1.0, 1.0], [1.0, 3.0]) == pytest.approx(0.5)


def test_compile_cache_env_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert configure_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = configure_compile_cache()
        assert path == os.path.join(REPO_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_last_line_is_the_device_json(monkeypatch, capsys):
    """The driver reads the last stdout line; fake a GPU to check it."""

    class FakeDev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(cs, "device_report", lambda: None)
    monkeypatch.setattr(cs, "nvidia_smi_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "check_multi_device", lambda devices: None)
    monkeypatch.setattr(cs.jax, "devices", lambda: [FakeDev()] * 4)
    cs.main(["--gpus", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
