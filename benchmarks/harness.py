# SPDX-License-Identifier: Apache-2.0
"""Device-time benchmark harness and the shared compile-cache setting.

Counterpart of the reference's CUDA-event Timer (benchmarks/utils.py:76-270):

- the benchmarked op runs ``iters`` times inside one jitted ``lax.fori_loop``,
- each iteration perturbs the op's input by a data-dependent epsilon
  (~1e-30) so XLA cannot hoist or dedupe iterations,
- one scalar is fetched at the end.  Timing two loop lengths (N and 4N) and
  differencing cancels dispatch/transfer overhead exactly.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure_compile_cache() -> str:
    """Give JAX's persistent compile cache one fixed directory; return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is overridden here.  Otherwise the cache lives in
    ``<repo>/.jax_cache`` (git-ignored) — a fixed path, because the
    directory is part of the cache key and a moving one never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def chain_loop(step_fn, dep_fn, iters: int):
    """jit(fori_loop) chaining ``step_fn`` through ``dep_fn`` ``iters`` times."""

    @jax.jit
    def run(args):
        def body(_, a):
            out = step_fn(*a)
            return dep_fn(a, out)

        final = jax.lax.fori_loop(0, iters, body, args)
        leaves = jax.tree_util.tree_leaves(final)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)

    return run


def measure(step_fn, dep_fn, args, iters: int = 8,
            min_diff_s: float = 0.040, max_iters: int = 4096):
    """Per-iteration device seconds via the two-loop-length difference.

    The difference ``t(4N) - t(N)`` must comfortably exceed the host-side
    dispatch noise (~ms class) or the result is the timer floor, not the
    op.  When the difference lands under ``min_diff_s``, the loop
    length is scaled up (paying one recompile per retry) until the
    measured window is trustworthy or ``max_iters`` is hit.
    """
    while True:
        run_a = chain_loop(step_fn, dep_fn, iters)
        run_b = chain_loop(step_fn, dep_fn, 4 * iters)
        float(run_a(args))  # compile + warm
        float(run_b(args))
        t0 = time.time()
        float(run_a(args))
        ta = time.time() - t0
        t0 = time.time()
        float(run_b(args))
        tb = time.time() - t0
        diff = tb - ta
        if diff >= min_diff_s or iters >= max_iters:
            return max(diff, 1e-9) / (3 * iters)
        scale = min(max(int(min_diff_s / max(diff, 1e-4) + 1), 2), 16)
        iters = min(iters * scale, max_iters)


def perturb_positions(scale=1e-30):
    """dep_fn factory: nudge args[0] by a data-dependent epsilon."""

    def dep(args, out):
        # data-depend on EVERY output leaf: anything the hash does not
        # touch is dead code XLA will eliminate, silently turning an
        # "energies+forces" measurement into forces-only (D3 pass-2 work
        # vanishes when only forces are consumed)
        leaves = jax.tree_util.tree_leaves(out)
        h = sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
        eps = (jnp.abs(h) % 2.0) * scale
        new0 = args[0] + eps.astype(args[0].dtype)
        return (new0,) + tuple(args[1:])

    return dep
