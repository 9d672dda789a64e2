"""Box-QP solver tests.  Oracle: scipy L-BFGS-B on the quadratic with bounds
(an independent, well-tested bound-constrained optimizer)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

from mpc_quad_ros_tpu.ops import lanes
from mpc_quad_ros_tpu.ops.qp import (
    solve_box_qp_pdip,
    solve_box_qp_projected_newton,
    qp_kkt_residual,
)


def random_qp(rng, nz, box=(0.0, 1.0), cond=10.0):
    A = rng.standard_normal((nz, nz))
    H = A @ A.T + np.eye(nz) / cond
    g = rng.standard_normal(nz) * 3
    lb = np.full(nz, box[0])
    ub = np.full(nz, box[1])
    return H, g, lb, ub


def scipy_solution(H, g, lb, ub):
    fun = lambda z: 0.5 * z @ H @ z + g @ z
    jac = lambda z: H @ z + g
    z0 = np.clip(np.zeros_like(g), lb, ub)
    res = minimize(fun, z0, jac=jac, method="L-BFGS-B",
                   bounds=list(zip(lb, ub)), options={"ftol": 1e-16, "gtol": 1e-12})
    return res.x


@pytest.mark.parametrize("method,iters", [("pdip", 25), ("pn", 12)])
def test_matches_scipy_on_random_qps(method, iters):
    rng = np.random.default_rng(0)
    for trial in range(12):
        nz = rng.integers(4, 41)
        H, g, lb, ub = random_qp(rng, int(nz))
        ref = scipy_solution(H, g, lb, ub)
        if method == "pdip":
            z = solve_box_qp_pdip(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub), iters=iters)
        else:
            z = solve_box_qp_projected_newton(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub), iters=iters)
        np.testing.assert_allclose(np.asarray(z), ref, atol=2e-5,
                                   err_msg=f"method={method} trial={trial} nz={nz}")


def test_kkt_residual_small():
    rng = np.random.default_rng(1)
    H, g, lb, ub = random_qp(rng, 40)
    z = solve_box_qp_pdip(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub), iters=30)
    kkt = float(qp_kkt_residual(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub), z))
    assert kkt < 1e-6


def test_unconstrained_interior_solution():
    """When the minimiser is strictly inside the box, both methods must hit
    the Newton solution -H^-1 g."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((10, 10))
    H = A @ A.T + 10 * np.eye(10)
    z_star = rng.uniform(0.3, 0.7, 10)
    g = -H @ z_star
    for solver, iters in ((solve_box_qp_pdip, 30), (solve_box_qp_projected_newton, 10)):
        z = solver(jnp.asarray(H), jnp.asarray(g), jnp.zeros(10), jnp.ones(10), iters=iters)
        np.testing.assert_allclose(np.asarray(z), z_star, atol=1e-6)


def test_fully_saturated():
    """Strong negative gradient -> everything pinned at the upper bound."""
    H = np.eye(6)
    g = -100 * np.ones(6)
    for solver in (solve_box_qp_pdip, solve_box_qp_projected_newton):
        z = solver(jnp.asarray(H), jnp.asarray(g), jnp.zeros(6), jnp.ones(6))
        np.testing.assert_allclose(np.asarray(z), 1.0, atol=1e-6)


def test_vmap_batch():
    rng = np.random.default_rng(3)
    Hs, gs = [], []
    for _ in range(16):
        H, g, lb, ub = random_qp(rng, 12)
        Hs.append(H)
        gs.append(g)
    Hs, gs = jnp.asarray(np.stack(Hs)), jnp.asarray(np.stack(gs))
    lb, ub = jnp.zeros(12), jnp.ones(12)
    zs = jax.vmap(lambda H, g: solve_box_qp_pdip(H, g, lb, ub, iters=25))(Hs, gs)
    for i in range(16):
        ref = scipy_solution(np.asarray(Hs[i]), np.asarray(gs[i]), np.zeros(12), np.ones(12))
        np.testing.assert_allclose(np.asarray(zs[i]), ref, atol=2e-5)


def _random_qps(B, nz, seed, dtype):
    A = jax.random.normal(jax.random.PRNGKey(seed), (B, nz, nz), dtype)
    H = jnp.einsum("bij,bkj->bik", A, A) + 0.5 * jnp.eye(nz, dtype=dtype)
    g = jax.random.normal(jax.random.PRNGKey(seed + 1), (B, nz), dtype) * 3
    lb = jnp.broadcast_to(-jnp.linspace(0.1, 1.0, nz, dtype=dtype), (B, nz))
    return H, g, lb, lb + 1.0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("B,nz", [(1, 40), (100, 16), (256, 40)])
def test_lanes_box_qp_matches_pdip_oracle(B, nz, warm):
    """`lanes.box_qp_pdip` is `ops/qp.solve_box_qp_pdip` run lanes-last:
    same start, barrier schedule, step rule and dual outputs."""
    H, g, lb, ub = _random_qps(B, nz, 3, jnp.float64)
    zl0 = zu0 = None
    if warm:
        zl0 = jax.random.uniform(jax.random.PRNGKey(7), (B, nz), jnp.float64, 0.0, 2.0)
        zu0 = jax.random.uniform(jax.random.PRNGKey(8), (B, nz), jnp.float64, 0.0, 2.0)
    ref = jax.vmap(lambda H, g, l, u, a, b: solve_box_qp_pdip(
        H, g, l, u, iters=10, zl0=a, zu0=b, return_duals=True),
        in_axes=(0, 0, 0, 0, 0 if warm else None, 0 if warm else None))(
            H, g, lb, ub, zl0, zu0)
    last = lambda a: None if a is None else jnp.moveaxis(a, 0, -1)
    out = lanes.box_qp_pdip(last(H), last(g), last(lb), last(ub), last(zl0),
                            last(zu0), iters=10)
    for o, r in zip(out, ref):
        assert o.shape == (nz, B)
        np.testing.assert_allclose(np.asarray(o).T, np.asarray(r), atol=1e-9)
