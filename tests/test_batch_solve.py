"""The batched solve path (`SQPSolver.solve_batch`, `ops/lanes.py`) against
its per-scenario oracle `SQPSolver.solve` (the lanes-last QP against
`ops/qp.py` is in test_qp.py, the drag tangent rule in test_soa.py, the
batched Riccati IPM in test_riccati.py).

In float64 the batched path runs the oracle's algorithm exactly, so the
comparison is tight; in float32 both sit within the IPM's convergence slack
of the f64 solution and are compared against it, never against each other."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics
from mpc_quad_ros_tpu.models.params import hummingbird_params
from mpc_quad_ros_tpu.models.rgp import rgp_init
from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver
from mpc_quad_ros_tpu.ops.sqp import init_carry

F32, F64 = jnp.float32, jnp.float64


def _problem(B, N, with_aug, dtype, qp_iters=12, seed=0, vel=2.0, off=(0.2, 1.0),
             **cfg_kw):
    p = hummingbird_params(dtype=dtype)
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input),
                    qp_iters=qp_iters, **cfg_kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
    x0 = x0.at[:, 7:10].add(jax.random.uniform(k1, (B, 3), dtype, -vel, vel))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, N, 13))
    y_ref = y_ref.at[:, :, 0].add(jax.random.uniform(k2, (B, 1), dtype, *off))
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    rgp = None
    if with_aug:
        rgp1 = rgp_init(jnp.linspace(-10, 10, 10, dtype=dtype), theta=(3.0, 0.1, 0.01))
        rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)
        rgp = rgp._replace(mu_g=0.3 * jax.random.normal(k2, rgp.mu_g.shape, dtype))
    return solver, carry, x0, y_ref, rgp


@pytest.mark.parametrize("with_aug", [False, True], ids=["nominal", "rgp"])
@pytest.mark.parametrize("N", [10, 40])
@pytest.mark.parametrize("B", [1, 127, 128, 300])
def test_solve_batch_matches_f64_oracle(B, N, with_aug):
    """Batch sizes on both sides of LANES_MIN_BATCH and of any power-of-two
    tiling, a short horizon (lanes-last form) and a long one (past
    LANES_MAX_N: the vmapped per-scenario form), nominal and RGP-augmented:
    the batched path is the oracle's algorithm (same iterates), checked in
    float64."""
    solver, carry, x0, y_ref, rgp = _problem(B, N, with_aug, F64)
    c_b, sol_b = jax.jit(solver.solve_batch)(carry, x0, y_ref, y_ref[:, -1], rgp)
    c_v, sol_v = jax.jit(jax.vmap(solver.solve))(carry, x0, y_ref, y_ref[:, -1], rgp)
    assert sol_b.U.shape == (B, N, 4) and sol_b.X.shape == (B, N + 1, 13)
    np.testing.assert_allclose(np.asarray(sol_b.U), np.asarray(sol_v.U), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol_b.X), np.asarray(sol_v.X), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sol_b.cost), np.asarray(sol_v.cost), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(sol_b.kkt_residual),
                               np.asarray(sol_v.kkt_residual), atol=1e-6)


def test_solve_batch_f32_within_bounds_of_f64_oracle():
    """The production dtype: f32 batched controls within 1e-2 of the f64
    oracle and the QP KKT residual within 5e-4, near hover (|v| <= 0.25 m/s,
    references <= 0.25 m away).  Further from hover the f32 condensed IPM's
    own floor grows past both bounds on any device (PERF.md)."""
    B, N = 128, 10
    solver, carry, x0, y_ref, rgp = _problem(B, N, True, F32, vel=0.25, off=(0.0, 0.25))
    _, sol = jax.jit(solver.solve_batch)(carry, x0, y_ref, y_ref[:, -1], rgp)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, F64), t)
    s64 = SQPSolver(solver.cfg, make_mpc_dynamics(hummingbird_params(dtype=F64)))
    _, ref = jax.jit(jax.vmap(s64.solve))(cast(carry), cast(x0), cast(y_ref),
                                          cast(y_ref[:, -1]), cast(rgp))
    assert np.abs(np.asarray(sol.U, np.float64) - np.asarray(ref.U)).max() <= 1e-2
    assert float(np.max(np.asarray(sol.kkt_residual))) <= 5e-4


def test_solve_batch_matches_vmapped_solve():
    """Batch-major path == per-scenario path in the production dtype (f32):
    matched solution quality, loose element-wise agreement."""
    B = 8
    solver, carry, x0, y_ref, _ = _problem(B, 10, False, F32, qp_iters=25)
    _, sol_ref = jax.vmap(lambda c, x, yr: solver.solve(c, x, yr, yr[-1], None))(
        carry, x0, y_ref)
    _, sol_bat = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], None)
    np.testing.assert_allclose(np.asarray(sol_bat.cost), np.asarray(sol_ref.cost),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sol_bat.U), np.asarray(sol_ref.U), atol=5e-2)
    np.testing.assert_allclose(np.asarray(sol_bat.X), np.asarray(sol_ref.X), atol=2e-1)





def test_solve_batch_riccati_small_batch_fallback():
    """Nominal model, tiny batch: same answers as `solve` per scenario."""
    B, N = 4, 12
    solver, carry, x0, y_ref, _ = _problem(B, N, False, F32, qp_method="riccati")
    _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1])
    _, sol_v = jax.vmap(lambda c, x, yr: solver.solve(c, x, yr, yr[-1]))(carry, x0, y_ref)
    np.testing.assert_allclose(np.asarray(sol.U), np.asarray(sol_v.U), atol=1e-6)


@pytest.mark.gpu
def test_solve_batch_on_gpu_matches_cpu(gpu_device):
    """On the card: the compiled f32 batched solve agrees with the same
    program on the CPU within the f32 convergence slack, and is finite."""
    B = 256
    solver, carry, x0, y_ref, rgp = _problem(B, 10, True, F32)
    args = (carry, x0, y_ref, y_ref[:, -1], rgp)
    on = lambda d: jax.device_put(args, d)
    _, sol_g = jax.jit(solver.solve_batch)(*on(gpu_device))
    _, sol_c = jax.jit(solver.solve_batch)(*on(jax.devices("cpu")[0]))
    assert np.isfinite(np.asarray(sol_g.U)).all()
    np.testing.assert_allclose(np.asarray(sol_g.U), np.asarray(sol_c.U), atol=2e-2)


@pytest.mark.slow
def test_fused_episode_batch_matches_vmap_of_scan():
    from mpc_quad_ros_tpu.loop import EpisodeConfig, run_episode_batch, run_episode_batch_fused

    B, T = 4, 8
    p1 = hummingbird_params(dtype=F32)
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p1.hover_input), qp_iters=25))
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p1))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p1)
    key = jax.random.PRNGKey(1)
    x0 = jnp.zeros((B, 13), F32).at[:, 3].set(1.0).at[:, 2].set(3.0)
    traj = jnp.zeros((B, T, 13), F32).at[:, :, 3].set(1.0).at[:, :, 2].set(3.0)
    traj = traj.at[:, :, 0].set(
        jnp.linspace(0, 1, T, dtype=F32)[None, :] * jax.random.uniform(key, (B, 1), F32, 0.5, 2.0))
    rgp1 = rgp_init(jnp.linspace(-5, 5, 8, dtype=F32), theta=(3.0, 0.1, 0.01))
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)

    _, o_ref = run_episode_batch(cfg, solver, pb, x0, traj, T, rgp)
    _, o_fus = run_episode_batch_fused(cfg, solver, pb, x0, traj, T, rgp)
    # two equally-converged f32 solvers; chained ticks amplify rounding at
    # active-set boundaries, 0.1 still catches wiring bugs (O(1) off)
    np.testing.assert_allclose(np.asarray(o_fus.w_odom), np.asarray(o_ref.w_odom), atol=1e-1)
    np.testing.assert_allclose(np.asarray(o_fus.x_odom), np.asarray(o_ref.x_odom), atol=1e-1)
    np.testing.assert_allclose(np.asarray(o_fus.rgp_mu_g_t), np.asarray(o_ref.rgp_mu_g_t), atol=1e-1)


@pytest.mark.slow
def test_nan_lane_isolation_in_tiled_solve():
    """A NaN scenario must not perturb any other scenario of the batch:
    every batched operation is per scenario.  Pinned bitwise."""
    B = 128
    solver, carry, x0, y_ref, rgp = _problem(B, 10, True, F32, qp_iters=6)
    _, sol_clean = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    x0_bad = x0.at[7, 8].set(jnp.nan)
    carry_bad = jax.vmap(lambda x: init_carry(solver.cfg, x))(x0_bad)
    _, sol_bad = solver.solve_batch(carry_bad, x0_bad, y_ref, y_ref[:, -1], rgp)
    U_c, U_b = np.asarray(sol_clean.U), np.asarray(sol_bad.U)
    assert np.isnan(U_b[7]).any()
    mask = np.arange(B) != 7
    np.testing.assert_array_equal(U_b[mask], U_c[mask])
