"""Dynamics tests, including the golden parity oracle: the reference's
recorded `x_pred_odom` equals RK4(x_odom, w_odom, 0.01) of the nominal
hummingbird model to machine precision (verified against
outputs/gazebo_simulation/data/traj2_v10_a10_gp0.pkl)."""

import numpy as np
import jax
import jax.numpy as jnp

from mpc_quad_ros_tpu.models.params import (
    default_params,
    hummingbird_params,
    crazyflie_params,
    params_from_xacro,
    randomize_params,
)
from mpc_quad_ros_tpu.models.dynamics import (
    f_nominal,
    f_with_drag,
    a_drag_body,
    rk4_step,
    plant_step,
    plant_substeps,
    compute_a_drag_target,
)


def hover_state(dtype=jnp.float64):
    return jnp.asarray([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def test_golden_nominal_prediction_parity(golden_gazebo_log):
    """x_pred_odom[k] == RK4_nominal(x_odom[k], clip(w_odom[k]), 0.01)."""
    p = hummingbird_params(dtype=jnp.float64)
    X = jnp.asarray(golden_gazebo_log["x_odom"])
    U = jnp.clip(jnp.asarray(golden_gazebo_log["w_odom"]), 0.0, 1.0)
    P = golden_gazebo_log["x_pred_odom"]

    step = jax.jit(jax.vmap(lambda x, u: rk4_step(lambda a, b: f_nominal(a, b, p), x, u, 0.01)))
    pred = np.asarray(step(X, U))
    np.testing.assert_allclose(pred, P, atol=1e-12)


def test_xacro_params_match_hardcoded(reference_tree):
    a = params_from_xacro(str(reference_tree / "config/hummingbird.xacro"), dtype=jnp.float64)
    b = hummingbird_params(dtype=jnp.float64)
    for la, lb in zip(a, b):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), rtol=1e-12)


def test_hover_equilibrium():
    """At hover input, the drag-free quad stays put."""
    for mk in (default_params, hummingbird_params, crazyflie_params):
        p = mk(dtype=jnp.float64)
        x = hover_state()
        u = jnp.full((4,), p.hover_input, dtype=jnp.float64)
        dx = f_nominal(x, u, p)
        np.testing.assert_allclose(np.asarray(dx), 0.0, atol=1e-12)


def test_drag_opposes_velocity():
    p = hummingbird_params(dtype=jnp.float64)
    x = hover_state().at[7:10].set(jnp.asarray([3.0, -2.0, 1.0]))
    a = np.asarray(a_drag_body(x, p))
    v = np.asarray(x[7:10])
    assert np.all(a * v <= 0)
    # quadratic + linear terms, identity attitude: check closed form on axis x
    expected = -(0.008 * 9.0 + 0.3 * 3.0) / float(p.mass)
    np.testing.assert_allclose(a[0], expected, rtol=1e-12)
    # no rotor drag on z
    np.testing.assert_allclose(a[2], -(0.008 * 1.0) / float(p.mass), rtol=1e-12)


def test_rotor_fault_injection_reduces_thrust():
    p = hummingbird_params(dtype=jnp.float64)
    p_faulty = p._replace(rotor_functionality=jnp.asarray([0.5, 1.0, 1.0, 1.0], dtype=jnp.float64))
    x = hover_state()
    u = jnp.full((4,), 0.5, dtype=jnp.float64)
    dv_h = f_nominal(x, u, p)[9]
    dv_f = f_nominal(x, u, p_faulty)[9]
    assert dv_f < dv_h


def test_plant_substeps_equals_manual_loop():
    p = hummingbird_params(dtype=jnp.float64)
    x = hover_state().at[7:10].set(jnp.asarray([1.0, 0.5, -0.2]))
    u = jnp.asarray([0.3, 0.31, 0.29, 0.3], dtype=jnp.float64)
    x_scan = plant_substeps(x, u, p, 0.005, 20)
    x_loop = x
    for _ in range(20):
        x_loop = plant_step(x_loop, u, p, 0.005)
    np.testing.assert_allclose(np.asarray(x_scan), np.asarray(x_loop), atol=1e-12)


def test_control_clamped_in_plant():
    p = hummingbird_params(dtype=jnp.float64)
    x = hover_state()
    out_of_range = jnp.asarray([-0.5, 1.5, 0.5, 0.5], dtype=jnp.float64)
    clamped = jnp.asarray([0.0, 1.0, 0.5, 0.5], dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(plant_step(x, out_of_range, p, 0.01)),
        np.asarray(plant_step(x, clamped, p, 0.01)),
        atol=0,
    )


def test_compute_a_drag_target():
    """Label = (v_body(now) - v_body(pred)) / dt with correct frames."""
    x_now = hover_state().at[7:10].set(jnp.asarray([1.0, 0.0, 0.0]))
    x_prev = hover_state().at[7:10].set(jnp.asarray([2.0, 0.0, 0.0]))
    v_b, a_d = compute_a_drag_target(x_now, x_prev, 0.1)
    np.testing.assert_allclose(np.asarray(v_b), [1.0, 0.0, 0.0], atol=1e-15)
    np.testing.assert_allclose(np.asarray(a_d), [-10.0, 0.0, 0.0], atol=1e-12)


def test_batched_params_vmap():
    key = jax.random.PRNGKey(0)
    base = hummingbird_params(dtype=jnp.float64)
    batch = randomize_params(base, key, 16)
    x = jnp.broadcast_to(hover_state(), (16, 13))
    u = jnp.full((16, 4), 0.3, dtype=jnp.float64)
    dx = jax.vmap(f_with_drag)(x, u, batch)
    assert dx.shape == (16, 13)
    assert np.isfinite(np.asarray(dx)).all()
