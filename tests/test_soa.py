"""SoA (lane-major) linearization parity: `models/dynamics_soa.py` through
`ops/lanes.linearize` must reproduce the jacfwd-of-AoS sensitivities and the
batched solver results exactly (same ops, different layout — x64 CPU makes
the comparison tight)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_quad_ros_tpu.models.augmented import drag_mean, fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu.models.dynamics_soa import make_mpc_dynamics_soa
from mpc_quad_ros_tpu.models.params import hummingbird_params
from mpc_quad_ros_tpu.models.rgp import rgp_init
from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver
from mpc_quad_ros_tpu.ops.sqp import init_carry


def _random_states(key, M):
    kx, ku = jax.random.split(key)
    x = jax.random.normal(kx, (M, 13)) * 0.5
    x = x.at[:, 3].add(1.0)  # near-identity, non-unit quaternions
    u = jax.random.uniform(ku, (M, 4), minval=0.1, maxval=0.9)
    return x, u


def _batched_rgp(key, B, nb=8):
    st = rgp_init(jnp.linspace(-6.0, 6.0, nb), theta=(1.0, 0.4, 0.1))
    st = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape).copy(), st)
    return st._replace(mu_g=0.3 * jax.random.normal(key, (B, 3, nb)))


@pytest.mark.parametrize("with_aug", [False, True])
def test_f_soa_matches_aos(with_aug):
    p = hummingbird_params()
    f = make_mpc_dynamics(p)
    f_soa = make_mpc_dynamics_soa(p)
    key = jax.random.PRNGKey(0)
    x, u = _random_states(key, 32)
    if with_aug:
        aug1 = fold_drag(_batched_rgp(key, 1))
        aug_shared = jax.tree.map(lambda a: a[0], aug1)       # (3, nb) shared
        dx_aos = jax.vmap(lambda x, u: f(x, u, aug_shared))(x, u)
        dx_soa = f_soa(x.T, u.T, aug_shared).T
    else:
        dx_aos = jax.vmap(lambda x, u: f(x, u, None))(x, u)
        dx_soa = f_soa(x.T, u.T, None).T
    np.testing.assert_allclose(np.asarray(dx_soa), np.asarray(dx_aos), atol=1e-12)


@pytest.mark.parametrize("with_aug", [False, True])
def test_linearize_soa_matches_jacfwd(with_aug):
    """The lanes-last SoA linearization of `solve_batch` equals vmapped jacfwd
    of the AoS model, and so do the condensed problems built from it."""
    p = hummingbird_params()
    cfg = MPCConfig()
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    key = jax.random.PRNGKey(1)
    B, N = 4, cfg.n_nodes
    x, u = _random_states(key, B * (N + 1))
    X = x.reshape(B, N + 1, 13)
    U = u[: B * N].reshape(B, N, 4)
    aug = fold_drag(_batched_rgp(key, B)) if with_aug else None

    A_ref, B_ref, r_ref = jax.vmap(solver._linearize, in_axes=(0, 0, 0 if with_aug else None))(
        X, U, aug)
    A, Bm, r = solver._linearize_batch(X, U, aug)
    np.testing.assert_allclose(np.asarray(A), np.asarray(A_ref), atol=1e-10)
    np.testing.assert_allclose(np.asarray(Bm), np.asarray(B_ref), atol=1e-10)
    np.testing.assert_allclose(np.asarray(r), np.asarray(r_ref), atol=1e-10)

    refs = (X, U, X[:, 0], X[:, :-1], X[:, -1])
    H, g, lb, ub, M, d = jax.vmap(solver._cost_from_lin)(*refs, A, Bm, r)
    H2, g2, lb2, ub2, M2, d2 = jax.vmap(solver._assemble, in_axes=(0,) * 5 + (
        0 if with_aug else None,))(*refs, aug)
    np.testing.assert_allclose(np.asarray(H), np.asarray(H2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d2), atol=1e-10)


def test_solve_batch_soa_matches_single_solve():
    """solve_batch (small batch: the vmapped per-scenario form) must agree
    with the single-scenario solve on the optimal controls."""
    p = hummingbird_params()
    cfg = MPCConfig()
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    key = jax.random.PRNGKey(2)
    B = 4
    x0 = jnp.zeros((B, 13)).at[:, 3].set(1.0)
    x0 = x0 + 0.02 * jax.random.normal(key, (B, 13))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, cfg.n_nodes, 13)) + 0.1
    y_ref_N = y_ref[:, -1]
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    aug = _batched_rgp(key, B)

    _, sol_b = solver.solve_batch(carry, x0, y_ref, y_ref_N, aug)
    _, sol_s = jax.vmap(lambda c, x, yr, yN, a: solver.solve(
        jax.tree.map(lambda l: l, c), x, yr, yN, a))(
        jax.vmap(lambda x: init_carry(cfg, x))(x0), x0, y_ref, y_ref_N, aug)
    np.testing.assert_allclose(np.asarray(sol_b.U), np.asarray(sol_s.U),
                               atol=5e-6)


def test_solve_batch_tiled_pipeline_matches_single_solve():
    """B = 128 engages the lanes-last form (SoA linearization, lanes-last
    box QP); must agree with the vmapped single-scenario solver."""
    p = hummingbird_params()
    cfg = MPCConfig()
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    key = jax.random.PRNGKey(7)
    B = 128
    x0 = jnp.zeros((B, 13)).at[:, 3].set(1.0) + 0.02 * jax.random.normal(key, (B, 13))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, cfg.n_nodes, 13)) + 0.1
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    aug = _batched_rgp(key, B)

    _, sol_b = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], aug)
    _, sol_s = jax.vmap(lambda c, x, yr, yN, a: solver.solve(c, x, yr, yN, a))(
        carry, x0, y_ref, y_ref[:, -1], aug)
    np.testing.assert_allclose(np.asarray(sol_b.U), np.asarray(sol_s.U), atol=5e-6)
    np.testing.assert_allclose(np.asarray(sol_b.X), np.asarray(sol_s.X), atol=5e-6)
    np.testing.assert_allclose(np.asarray(sol_b.kkt_residual),
                               np.asarray(sol_s.kkt_residual), atol=1e-6)


def test_drag_mean_custom_jvp_matches_autodiff():
    """The diagonal drag tangent rule equals plain forward-mode AD."""
    k = jax.random.split(jax.random.PRNGKey(2), 6)
    M, nb = 7, 10
    vb = jax.random.normal(k[0], (3, M), jnp.float64) * 3
    X_b = jax.random.normal(k[1], (3, nb, M), jnp.float64) * 5
    w_b = jax.random.normal(k[2], (3, nb, M), jnp.float64)
    L_b = jax.random.uniform(k[3], (3, M), jnp.float64, 1.0, 4.0)
    sf_b = jax.random.uniform(k[4], (3, M), jnp.float64, 0.05, 0.5)
    t = jax.random.normal(k[5], (3, M), jnp.float64)

    def plain(v):
        diff = v[:, None] - X_b
        kk = sf_b[:, None] ** 2 * jnp.exp(-0.5 * diff**2 / L_b[:, None] ** 2)
        return jnp.sum(kk * w_b, axis=1)

    y, dy = jax.jvp(lambda v: drag_mean(v, X_b, w_b, L_b, sf_b), (vb,), (t,))
    y2, dy2 = jax.jvp(plain, (vb,), (t,))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(dy), np.asarray(dy2), rtol=1e-12, atol=1e-14)
