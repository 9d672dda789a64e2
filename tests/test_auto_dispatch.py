"""qp_method="auto" backend dispatch: the condensed IPM below
`AUTO_RICCATI_MIN_N` (from the H100 crossover sweep of
`bench.suite.riccati_crossover`, PERF.md), the O(N) Riccati IPM from it on;
and solve_batch's choice of form by batch size and horizon
(`LANES_MIN_BATCH`, `LANES_MAX_N`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics
from mpc_quad_ros_tpu.models.params import hummingbird_params
from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver
from mpc_quad_ros_tpu.ops.sqp import (AUTO_RICCATI_MIN_N, LANES_MAX_N, LANES_MIN_BATCH,
                                      init_carry)

DTYPE = jnp.float32


def _solver(**kw):
    p = hummingbird_params(dtype=DTYPE)
    cfg = MPCConfig(u_ref=float(p.hover_input), **kw)
    return SQPSolver(cfg, make_mpc_dynamics(p)), cfg


def test_resolution_table():
    s, _ = _solver(qp_method="auto", n_nodes=10)
    assert s._resolve_qp_method() == "pdip"
    s, _ = _solver(qp_method="auto", n_nodes=AUTO_RICCATI_MIN_N - 1,
                   t_horizon=(AUTO_RICCATI_MIN_N - 1) / 10)
    assert s._resolve_qp_method() == "pdip"
    s, _ = _solver(qp_method="auto", n_nodes=AUTO_RICCATI_MIN_N,
                   t_horizon=AUTO_RICCATI_MIN_N / 10)
    assert s._resolve_qp_method() == "riccati"
    # explicit choices pass through untouched at any horizon
    s, _ = _solver(qp_method="riccati", n_nodes=10)
    assert s._resolve_qp_method() == "riccati"
    s, _ = _solver(qp_method="pdip", n_nodes=80, t_horizon=8.0)
    assert s._resolve_qp_method() == "pdip"


def test_auto_threshold_between_measured_horizons():
    """The H100 sweep (B=4096) measured the condensed IPM, in the form
    solve_batch dispatches to, faster than the Riccati IPM at N = 10, 20 and
    40; the threshold must sit past the last of them, and lanes-last
    solves must stop where that form was last measured."""
    assert AUTO_RICCATI_MIN_N > 40
    assert LANES_MAX_N == 20


@pytest.mark.parametrize("B,N", [(1, 10), (LANES_MIN_BATCH - 1, 10), (LANES_MIN_BATCH, 10),
                                 (LANES_MIN_BATCH, LANES_MAX_N),
                                 (LANES_MIN_BATCH, LANES_MAX_N + 1)])
def test_small_batches_take_the_per_scenario_form(B, N, monkeypatch):
    """Below LANES_MIN_BATCH scenarios or past LANES_MAX_N stages solve_batch
    IS the vmapped per-scenario solve; otherwise it runs the lanes-last
    kernels (`ops/lanes.py`)."""
    from mpc_quad_ros_tpu.ops import lanes

    calls = []
    real = lanes.box_qp_pdip
    monkeypatch.setattr(lanes, "box_qp_pdip",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    s, cfg = _solver(qp_iters=2, n_nodes=N, t_horizon=N / 10.0)
    carry, x0, y_ref = _inputs(cfg, B)
    jax.eval_shape(lambda c, x, yr: s.solve_batch(c, x, yr, yr[:, -1]), carry, x0, y_ref)
    assert bool(calls) == (B >= LANES_MIN_BATCH and N <= LANES_MAX_N)


def _inputs(cfg, B=4):
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((B, 13), DTYPE).at[:, 3].set(1.0).at[:, 2].set(3.0)
    x0 = x0.at[:, 7:10].add(jax.random.uniform(key, (B, 3), DTYPE, -2, 2))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, cfg.n_nodes, 13))
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    return carry, x0, y_ref


@pytest.mark.parametrize("n_nodes,explicit", [(10, "pdip"), (AUTO_RICCATI_MIN_N, "riccati")])
@pytest.mark.slow
def test_auto_solve_matches_explicit_backend(n_nodes, explicit):
    """auto-dispatched solve_batch == the explicitly-selected backend,
    bitwise (same code path after resolution)."""
    kw = dict(n_nodes=n_nodes, t_horizon=n_nodes / 10.0, qp_iters=4)
    s_auto, cfg = _solver(qp_method="auto", **kw)
    s_exp, _ = _solver(qp_method=explicit, **kw)
    carry, x0, y_ref = _inputs(cfg)
    _, sol_a = jax.jit(lambda c, x, yr: s_auto.solve_batch(c, x, yr, yr[:, -1]))(
        carry, x0, y_ref)
    _, sol_e = jax.jit(lambda c, x, yr: s_exp.solve_batch(c, x, yr, yr[:, -1]))(
        carry, x0, y_ref)
    np.testing.assert_array_equal(np.asarray(sol_a.U), np.asarray(sol_e.U))
    np.testing.assert_array_equal(np.asarray(sol_a.X), np.asarray(sol_e.X))
