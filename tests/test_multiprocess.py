"""Multi-PROCESS (multi-host stand-in) distribution tests — PRODUCTION
configuration (VERDICT r4 next #5).

BASELINE config 5 / SURVEY §2 distribution inventory: the scenario batch
sharded across N>=2 processes with psum'd QP/convergence reductions.  Real
multi-host hardware is not available here, but multi-process CORRECTNESS is
fully testable on CPU: 2 local processes x 4 virtual devices each, joined by
`jax.distributed.initialize` over a localhost coordinator with gloo
collectives — the code path several GPU hosts run, minus the transport.

Round 5 raises this from a smoke test to the production operating point:
qp_iters=12 through solve_batch (what bench.py measures), a
CHAIN of warm-started RTI solves per step (the tick chain), and a
closed-loop RGP-learning episode leg asserted against the single-process
oracle, not just cross-process agreement.

The oracle is the same computation run single-process in THIS process on the
8-virtual-device mesh (conftest sets --xla_force_host_platform_device_count=8),
built from the same deterministic `build_inputs` scenarios.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_quad_ros_tpu.parallel.launch import launch_workers
from mpc_quad_ros_tpu.parallel.mp_worker import build_inputs

pytestmark = pytest.mark.slow   # 2 subprocess compiles, ~6 min

GLOBAL_B = 1024          # 128 per device -> every shard takes the fused path
QP_ITERS = 12            # production iteration count (bench.py / MPCConfig)
CHAIN = 3                # warm-started RTI solves chained per step
TICKS = 3                # closed-loop learning ticks in the episode leg


@pytest.fixture(scope="module")
def mp_results():
    """One 2-process x 4-device run shared by the assertions below (spawning
    + double compile is the expensive part)."""
    return launch_workers(nproc=2, devices_per_process=4,
                          global_batch=GLOBAL_B, qp_iters=QP_ITERS,
                          ticks=TICKS, chain=CHAIN)


def _build():
    from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics
    from mpc_quad_ros_tpu.models.params import hummingbird_params
    from mpc_quad_ros_tpu.models.rgp import rgp_init
    from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver

    dtype = jnp.float32
    p = hummingbird_params(dtype=dtype)
    cfg = MPCConfig(u_ref=float(p.hover_input), qp_iters=QP_ITERS)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(jnp.linspace(-10, 10, 10, dtype=dtype),
                    theta=(3.0, 0.1, 0.01))
    return p, cfg, solver, rgp1


def _oracle():
    """Single-process reference of the identical chained computation."""
    from mpc_quad_ros_tpu.ops.sqp import init_carry

    p, cfg, solver, rgp1 = _build()
    x0, y_ref, ref = build_inputs(GLOBAL_B, cfg.n_nodes)
    x0, y_ref, ref = jnp.asarray(x0), jnp.asarray(y_ref), jnp.asarray(ref)
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (GLOBAL_B, 3) + a.shape),
                       rgp1)
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    sol = None
    for _ in range(CHAIN):
        carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
    return solver, p, cfg, sol, (x0, rgp)


def _assert_rows_match(a, ref, slack, label):
    """Equally-converged f32 runs may differ element-wise up to the
    12-iteration IPM's convergence slack (~1e-2 on hard instances — the
    XLA:CPU plain-jit vs shard_map lowerings sum the panel-live
    substitutions in different orders at a few ulps, which the
    fixed-iteration IPM amplifies; measured here max 1.1e-2, exactly the
    slack CLAUDE.md documents for run-vs-run comparisons).  So assert (a)
    closeness at the slack scale and (b) a ROUTING discriminator: each row
    must match ITS OWN oracle row far better than a shifted assignment —
    a swapped shard, stale scenario, or dropped chain step fails (b) even
    though (a)'s tolerance is loose."""
    np.testing.assert_allclose(a, ref, atol=slack, err_msg=label)
    direct = float(np.abs(a - ref).mean())
    shifted = float(np.abs(a - np.roll(ref, 1, axis=0)).mean())
    assert shifted > 10 * max(direct, 1e-7), (label, direct, shifted)


def test_two_process_chained_solve_matches_single_process(mp_results):
    r0, r1 = mp_results
    assert int(r0["n_devices_global"]) == 8
    assert int(r0["slice_start"]) == 0 and int(r1["slice_start"]) == GLOBAL_B // 2

    solver, p, cfg, sol, _ = _oracle()
    U_ref = np.asarray(sol.U)

    # shard agreement after a 3-deep warm-started chain at qp_iters=12
    _assert_rows_match(r0["U_local"], U_ref[: GLOBAL_B // 2], 3e-2, "shard 0")
    _assert_rows_match(r1["U_local"], U_ref[GLOBAL_B // 2:], 3e-2, "shard 1")

    # psum'd global reductions: both processes must report IDENTICAL global
    # sums (the same psum), and land near the oracle's — the cost is smooth
    # in the slack, the KKT residual is the slack itself so only its scale
    # is pinned vs the oracle
    assert float(r0["cost_sum"]) == float(r1["cost_sum"])
    assert float(r0["kkt_sum"]) == float(r1["kkt_sum"])
    for r in (r0, r1):
        assert float(r["n"]) == GLOBAL_B
        np.testing.assert_allclose(float(r["cost_sum"]),
                                   float(jnp.sum(sol.cost)), rtol=1e-3)
        np.testing.assert_allclose(float(r["kkt_sum"]),
                                   float(jnp.sum(sol.kkt_residual)), rtol=0.5)


def test_two_process_closed_loop_matches_single_process(mp_results):
    """The closed-loop RGP-learning leg (run_episode under the global mesh):
    per-shard trajectories equal the single-process oracle's, and the psum'd
    tracking error agrees across processes."""
    from mpc_quad_ros_tpu.loop import EpisodeConfig, run_episode

    r0, r1 = mp_results
    assert float(r0["ep_n"]) == GLOBAL_B
    np.testing.assert_allclose(float(r0["ep_sq_err_sum"]),
                               float(r1["ep_sq_err_sum"]), rtol=1e-6)

    # single-process oracle of the same episode inputs (mirrors mp_worker)
    p, cfg, solver, rgp1 = _build()
    x0_g, _, _ = build_inputs(GLOBAL_B, cfg.n_nodes)
    T = 6
    xt = np.zeros((GLOBAL_B, T, 13), np.float32)
    xt[:, :, 3] = 1.0
    xt[:, :, 2] = 3.0
    xt[:, :, 0] = np.linspace(0, 1, T, dtype=np.float32)[None, :]
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (GLOBAL_B, 3) + a.shape),
                       rgp1)
    ecfg = EpisodeConfig(mpc=cfg)
    _, outs = jax.jit(jax.vmap(
        lambda a, t, r: run_episode(ecfg, solver, p, a, t, TICKS, rgp0=r)
    ))(jnp.asarray(x0_g), jnp.asarray(xt), rgp)
    X_ref = np.asarray(outs.x_odom)

    x_mp = np.concatenate([r0["ep_x_local"], r1["ep_x_local"]], axis=0)
    assert np.isfinite(x_mp).all()
    # same slack-+ -routing discipline as the chained solve: the per-tick
    # controls carry the IPM slack into the state trajectory (measured max
    # 2.4e-2 over 3 learning ticks)
    _assert_rows_match(x_mp.reshape(GLOBAL_B, -1),
                       X_ref.reshape(GLOBAL_B, -1), 6e-2, "episode states")
