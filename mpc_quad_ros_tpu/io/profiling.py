"""Tracing / profiling utilities.

The reference's only instrumentation is wall-clock brackets around the acados
call (`t_cpu`, `elapsed_during_mpc` — SURVEY §5.1).  Here:

- `timed` / `Stopwatch`: wall-clock phase timers with block_until_ready.
- `profile_solver_phases`: per-phase breakdown of one batched MPC solve
  (linearize / condense / QP / expand), each phase its own jitted program.
- `trace`: context manager around `jax.profiler.trace` emitting a TensorBoard
  / Perfetto trace directory for the real thing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import jax.numpy as jnp


class Stopwatch:
    """Accumulating named phase timer."""

    def __init__(self):
        self.phases: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"total {total * 1e3:.2f} ms"]
        for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v * 1e3:8.2f} ms  {100 * v / total:5.1f}%")
        return "\n".join(lines)


def timed(fn: Callable, *args, iters: int = 10, warmup: bool = True) -> float:
    """Median-free steady-state seconds/call with compile excluded."""
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA-level trace (TensorBoard 'profile' plugin / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_solver_phases(solver, carry, x0, y_ref, aug=None, iters: int = 10) -> dict:
    """Wall-clock per-phase breakdown of one `solve_batch` Gauss-Newton step
    of the condensed backend.  All inputs batch-major (leading B)."""
    from ..models.augmented import fold_drag
    from ..ops import lanes
    from ..ops.qp import HP, qp_kkt_residual

    B = x0.shape[0]
    cfg = solver.cfg
    aug = fold_drag(aug)
    last = lambda a: jnp.moveaxis(a, 0, -1)

    lin = jax.jit(solver._linearize_batch)
    A, Bm, r = lin(carry.X, carry.U, aug)
    cond = jax.jit(jax.vmap(solver._cost_from_lin))
    cond_args = (carry.X, carry.U, x0, y_ref, y_ref[:, -1], A, Bm, r)
    H, g, lb, ub, M, d = cond(*cond_args)
    qp = jax.jit(lambda H, g, lb, ub: jnp.moveaxis(lanes.box_qp_pdip(
        last(H), last(g), last(lb), last(ub), iters=cfg.qp_iters)[0], -1, 0))
    z = qp(H, g, lb, ub)
    expand = jax.jit(lambda X, M, d, z, H, g, lb, ub: (
        X + d + jnp.einsum("bkxz,bz->bkx", M, z, precision=HP),
        jax.vmap(qp_kkt_residual)(H, g, lb, ub, z)))
    full = jax.jit(lambda c, x, yr, a: solver.solve_batch(c, x, yr, yr[:, -1], a)[1].U)

    res = {
        "linearize_s": timed(lin, carry.X, carry.U, aug, iters=iters),
        "condense_s": timed(cond, *cond_args, iters=iters),
        "qp_s": timed(qp, H, g, lb, ub, iters=iters),
        "expand_s": timed(expand, carry.X, M, d, z, H, g, lb, ub, iters=iters),
        "full_solve_s": timed(full, carry, x0, y_ref, aug, iters=iters),
        "batch": B,
    }
    res["solves_per_s"] = B / res["full_solve_s"]
    return res
