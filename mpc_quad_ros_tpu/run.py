"""Closed-loop simulation CLI — the `execute_trajectory.py` equivalent.

Usage parity with the reference driver (`/root/reference/src/execute_trajectory.py:53-169`):

    python -m mpc_quad_ros_tpu.run --gpe 2 --trajectory 2 --v_max 10 --a_max 10

--gpe 0: nominal MPC, 1: pretrained batch GP from --gp_path, 2: online RGP.
--trajectory 0: waypoints from file (--waypoints csv), 1: random waypoints
(min-snap), 2: accelerating circle.  Outputs a pickle log with the reference's
key names plus a tracking report.

New relative to the reference: --batch N runs N randomised scenarios as one
vmapped computation (drag coefficients randomised per episode), and the whole
closed loop is a single jit-compiled scan instead of a Python loop around an
acados binary.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from .io.config import SimConfig


def build_trajectory(cfg: SimConfig, x0_pos, mpc_dt: float):
    """Reference chunk source for the episode: (x_traj (T,13), t (T,))."""
    from .traj import (
        circle_trajectory_accelerating,
        min_snap_trajectory,
        random_waypoints,
        sample_polynomial_trajectory,
        states_from_flat_outputs,
    )

    if cfg.trajectory == 2:
        # circle: radius 10, t_max 30 (`execute_trajectory.py:150-155`)
        ts, pos, vel, acc = circle_trajectory_accelerating(10.0, cfg.v_max, t_max=30.0, dt=mpc_dt)
        return states_from_flat_outputs(np.asarray(pos), np.asarray(vel)), np.asarray(ts)
    if cfg.trajectory == 1:
        # random waypoints: hsize 30, 10 waypoints (`execute_trajectory.py:142-148`)
        wp = random_waypoints(hsize=30.0, num_waypoints=10, start_point=np.asarray(x0_pos), seed=cfg.seed)
        poly = min_snap_trajectory(wp, cfg.v_max, cfg.a_max)
        ts, pos, vel, acc = sample_polynomial_trajectory(poly, mpc_dt)
        return states_from_flat_outputs(pos, vel), ts
    if cfg.trajectory == 0:
        # 'static': user-defined waypoint file (`TrajectoryGenerator.py:26,177-183`)
        path = os.environ.get(
            "MPCQUAD_WAYPOINTS",
            os.path.join(os.path.dirname(__file__), "data", "user_defined_waypoints.csv"),
        )
        wp = np.loadtxt(path, delimiter=",", ndmin=2)[:, :3]
        poly = min_snap_trajectory(wp, cfg.v_max, cfg.a_max)
        ts, pos, vel, acc = sample_polynomial_trajectory(poly, mpc_dt)
        return states_from_flat_outputs(pos, vel), ts
    raise ValueError(f"invalid trajectory type {cfg.trajectory}")


def build_sim(cfg: SimConfig, dtype):
    """Everything `run_sim` builds before the closed loop runs:
    (episode config, solver, plant params, x0, x_traj, t_traj, rgp0, gp_aug)."""
    import jax
    import jax.numpy as jnp

    from .loop import EpisodeConfig
    from .models.augmented import make_mpc_dynamics
    from .models.ensemble import GPEnsemble
    from .models.params import crazyflie_params, default_params, hummingbird_params
    from .ops import MPCConfig, SQPSolver

    quad_mk = {"hummingbird": hummingbird_params, "default": default_params,
               "crazyflie": crazyflie_params}[cfg.quad]
    p = quad_mk(payload=cfg.payload, dtype=dtype)

    mpc = MPCConfig(n_nodes=cfg.n_nodes, t_horizon=cfg.t_lookahead, u_ref=float(p.hover_input))
    # full RGP posterior logging (C_g_t is (3, nb, nb)/tick) for runs whose
    # log a human will visualise; large scenario batches skip it — the
    # (B, T, 3, nb, nb) stack would dominate memory
    ecfg = EpisodeConfig(mpc=mpc, simulation_dt=cfg.simulation_dt,
                         log_rgp_posterior=cfg.batch <= 8)
    solver = SQPSolver(mpc, make_mpc_dynamics(p))

    # initial condition (`execute_trajectory.py:129`)
    x0 = jnp.asarray([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype)

    x_traj_np, t_traj = build_trajectory(cfg, np.asarray(x0[:3]), mpc.dt)
    x_traj = jnp.asarray(x_traj_np, dtype=dtype)

    # --- GPE modes (`execute_trajectory.py:99-109`) ---
    rgp0 = None
    gp_aug = None
    if cfg.gpe == 1:
        assert cfg.gp_path, "--gp_path required for --gpe 1"
        gpe = GPEnsemble.fromdir(cfg.gp_path, "GP")
        gp_aug = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), gpe.state)
    elif cfg.gpe == 2:
        if cfg.gp_from_file:
            gpe = GPEnsemble.fromdir(cfg.gp_path, "RGP")
        else:
            gpe = GPEnsemble.fromrange(
                [(-cfg.v_max, cfg.v_max)] * 3, cfg.n_basis, theta=cfg.rgp_theta, dtype=dtype
            )
        rgp0 = gpe.state
    return ecfg, solver, p, x0, x_traj, t_traj, rgp0, gp_aug


def run_sim(cfg: SimConfig, verbose: bool = True):
    """Build everything and run the closed loop.  Returns (logger, outs, extras)."""
    import jax
    import jax.numpy as jnp

    from .io.logger import Logger
    from .loop import run_episode, run_episode_batch
    from .models.params import randomize_params
    from .loop.episode import tracking_rmse

    cfg = cfg.clamp_limits()
    dtype = jnp.float32 if not os.environ.get("MPCQUAD_X64") else jnp.float64
    ecfg, solver, p, x0, x_traj, t_traj, rgp0, gp_aug = build_sim(cfg, dtype)
    n_ticks = x_traj.shape[0]

    if verbose:
        print(f"Optimizer MPC lookahead={cfg.t_lookahead}s, nodes={cfg.n_nodes}, "
              f"trajectory {n_ticks} ticks, gpe={cfg.gpe}, batch={cfg.batch}")

    t0 = time.perf_counter()
    if cfg.batch > 1:
        from .loop import run_episode_batch_fused

        B = cfg.batch
        key = jax.random.PRNGKey(cfg.seed)
        pb = randomize_params(p, key, B)
        x0b = jnp.broadcast_to(x0, (B, 13))
        trajb = jnp.broadcast_to(x_traj, (B,) + x_traj.shape)
        rgpb = (
            jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), rgp0)
            if rgp0 is not None else None
        )
        gp_augb = (
            jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), gp_aug)
            if gp_aug is not None else None
        )
        # large batches take the batch-major scan (one batched solve per
        # tick); small ones the vmap-of-scan path (less compile, same numerics)
        if B >= 32:
            final, outs = run_episode_batch_fused(ecfg, solver, pb, x0b, trajb,
                                                  n_ticks, rgpb, gp_aug=gp_augb)
        else:
            final, outs = run_episode_batch(ecfg, solver, pb, x0b, trajb, n_ticks,
                                            rgpb, gp_aug=gp_aug)
        import jax as _j

        _j.block_until_ready(outs.x_odom)
        elapsed = time.perf_counter() - t0
        rmse = np.asarray(tracking_rmse(outs))
        if verbose:
            print(f"{B} episodes x {n_ticks} ticks in {elapsed:.2f}s "
                  f"({B * n_ticks / elapsed:.0f} solves/s); rmse mean={rmse.mean():.3f} m "
                  f"min={rmse.min():.3f} max={rmse.max():.3f}")
        logger = Logger.from_episode(
            jax.tree.map(lambda a: a[0] if a is not None else None, outs),
            t_odom=t_traj[:n_ticks], filepath=cfg.output, solve_time_s=elapsed / B,
        )
        return logger, outs, {"elapsed": elapsed, "rmse": rmse, "t": t_traj}

    final, outs = jax.jit(
        lambda a, b, r: run_episode(ecfg, solver, p, a, b, n_ticks, rgp0=r)
    )(x0, x_traj, rgp0)
    jax.block_until_ready(outs.x_odom)
    elapsed = time.perf_counter() - t0
    rmse = float(tracking_rmse(outs))
    if verbose:
        print(f"episode: {n_ticks} ticks in {elapsed:.2f}s; RMSE pos = {rmse:.3f} m")
    logger = Logger.from_episode(outs, t_odom=t_traj[:n_ticks], filepath=cfg.output,
                                 solve_time_s=elapsed)
    return logger, outs, {"elapsed": elapsed, "rmse": rmse, "t": t_traj}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-o", "--output", type=str, default=None, help="Output data file (.pkl)")
    parser.add_argument("-p", "--plot_output", type=str, default=None, help="Output plot file")
    parser.add_argument("--gpe", type=int, required=True, choices=(0, 1, 2))
    parser.add_argument("--trajectory", type=int, required=True, choices=(0, 1, 2),
                        help="0 waypoint file, 1 random waypoints, 2 circle")
    parser.add_argument("--v_max", type=float, required=True)
    parser.add_argument("--a_max", type=float, required=True)
    parser.add_argument("--show", type=int, default=0)
    parser.add_argument("--batch", type=int, default=1, help="scenario batch size (vmapped)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quad", type=str, default="hummingbird",
                        choices=("hummingbird", "default", "crazyflie"))
    parser.add_argument("--payload", action="store_true")
    parser.add_argument("--n_basis", type=int, default=10)
    parser.add_argument("--n_nodes", type=int, default=10)
    parser.add_argument("--t_lookahead", type=float, default=1.0)
    parser.add_argument("--gp_path", type=str, default=None)
    parser.add_argument("--gp_from_file", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .io.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = SimConfig(
        gpe=args.gpe, trajectory=args.trajectory, v_max=args.v_max, a_max=args.a_max,
        output=args.output, plot_output=args.plot_output, show=bool(args.show),
        batch=args.batch, seed=args.seed, quad=args.quad, payload=args.payload,
        n_basis=args.n_basis, n_nodes=args.n_nodes, t_lookahead=args.t_lookahead,
        gp_path=args.gp_path, gp_from_file=args.gp_from_file,
    )
    logger, outs, extras = run_sim(cfg)

    if args.output:
        path = logger.save_log()
        print(f"Saving trajectory to {path}")
    if args.plot_output or args.show:
        from .io.viz import Visualiser

        viz = Visualiser.from_logger(logger)
        viz.plot_data(save_path=args.plot_output, show=bool(args.show))
    return 0


if __name__ == "__main__":
    sys.exit(main())
