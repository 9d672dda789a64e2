"""Extended benchmark suite: latency percentiles, throughput-vs-batch,
closed-loop learning throughput, and mesh weak-scaling.

`bench.py` at the repo root prints the single headline JSON line for the
driver; this module is the full measurement harness:

    python -m mpc_quad_ros_tpu.bench.suite --what latency
    python -m mpc_quad_ros_tpu.bench.suite --what throughput
    python -m mpc_quad_ros_tpu.bench.suite --what closed_loop
    python -m mpc_quad_ros_tpu.bench.suite --what scaling --devices 8  (CPU mesh)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def operating_point(B: int, seed: int = 0, dtype=jnp.float32, n_basis: int = 10,
                    vel: float = 3.0, ramp=(1.0, 5.0)):
    """The benchmark's reference operating point (N=10, 1 s horizon,
    RGP-augmented with `n_basis` basis vectors per axis): B hover states at
    3 m altitude with uniform +-`vel` m/s velocities and references that
    ramp up to `ramp` (uniform range) m ahead in x over the horizon.
    Returns (solver, carry, x0, y_ref, rgp)."""
    from ..models.params import hummingbird_params
    from ..models.augmented import make_mpc_dynamics
    from ..models.rgp import rgp_init
    from ..ops import MPCConfig, SQPSolver
    from ..ops.sqp import init_carry

    p = hummingbird_params(dtype=dtype)
    cfg = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(jnp.linspace(-10, 10, n_basis, dtype=dtype), theta=(3.0, 0.1, 0.01))
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
    x0 = x0.at[:, 7:10].add(jax.random.uniform(k1, (B, 3), dtype, -vel, vel))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, cfg.n_nodes, 13))
    y_ref = y_ref.at[:, :, 0].add(
        jnp.linspace(0, 1, cfg.n_nodes, dtype=dtype)[None, :]
        * jax.random.uniform(k2, (B, 1), dtype, *ramp))
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    return solver, carry, x0, y_ref, rgp


def _setup(B, dtype=jnp.float32, n_basis=10):
    from ..models.params import hummingbird_params
    from ..models.augmented import make_mpc_dynamics
    from ..models.rgp import rgp_init
    from ..ops import MPCConfig, SQPSolver
    from ..ops.sqp import init_carry

    p = hummingbird_params(dtype=dtype)
    cfg = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(jnp.linspace(-10, 10, n_basis, dtype=dtype), theta=(3.0, 0.1, 0.01))
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
    x0 = x0.at[:, 7:10].add(jax.random.uniform(key, (B, 3), dtype, -3, 3))
    y_ref = jnp.broadcast_to(x0[:, None, :], (B, cfg.n_nodes, 13))
    carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)
    return p, cfg, solver, carry, x0, y_ref, rgp


def latency(iters: int = 200) -> dict:
    """Single-solve (B=1) latency percentiles per host dispatch — the
    real-time-budget metric (reference: <=10 ms/solve) — plus the per-solve
    time of K warm-started solves chained in one dispatch."""
    p, cfg, solver, carry, x0, y_ref, rgp = _setup(1)
    f = jax.jit(lambda c, x, yr, r: solver.solve_batch(c, x, yr, yr[:, -1], r)[1].U)
    jax.block_until_ready(f(carry, x0, y_ref, rgp))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(carry, x0, y_ref, rgp))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3

    # K warm-started solves chained in one dispatch: the dispatch cost
    # amortizes away
    K = 50

    @jax.jit
    def chain(c, x, yr, r):
        def body(c, _):
            c2, sol = solver.solve_batch(c, x, yr, yr[:, -1], r)
            return c2, sol.cost.sum()
        return jax.lax.scan(body, c, None, length=K)

    jax.block_until_ready(chain(carry, x0, y_ref, rgp))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(carry, x0, y_ref, rgp))
    dev_ms = (time.perf_counter() - t0) / K * 1e3

    return {
        "metric": "single MPC solve latency",
        "p50_ms": float(np.percentile(ts, 50)),
        "p99_ms": float(np.percentile(ts, 99)),
        "mean_ms": float(ts.mean()),
        "device_ms_per_solve": float(dev_ms),
        "budget_ms": 10.0,
    }


def throughput(batches=(1024, 4096, 8192, 16384), iters: int = 10) -> list:
    """Warm-started solves chained in ONE dispatch (lax.scan, as the episode
    loop drives the solver), per batch size."""
    out = []
    for B in batches:
        p, cfg, solver, carry, x0, y_ref, rgp = _setup(B)

        @jax.jit
        def f(c, x, yr, r):
            def body(c, _):
                c2, sol = solver.solve_batch(c, x, yr, yr[:, -1], r)
                return c2, sol.cost.sum()
            return jax.lax.scan(body, c, None, length=iters)

        jax.block_until_ready(f(carry, x0, y_ref, rgp))
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(f(carry, x0, y_ref, rgp))
        dt = (time.perf_counter() - t0) / (iters * reps)
        out.append({"batch": B, "ms": dt * 1e3, "solves_per_s": B / dt})
    return out


def closed_loop_setup(B: int, v: float = 8.0, t_max: float = 10.0, seed: int = 0,
                      dtype=jnp.float32):
    """BASELINE config 4: B episodes on the accelerating circle (radius 10 m,
    top speed v) with per-episode randomized drag (`randomize_params`) and
    per-episode online RGP state.  Returns (cfg, solver, args, T) where
    `run_episode_batch_fused(cfg, solver, *args, T, rgp)` runs them; args =
    (plant params, x0, trajectories, RGP states)."""
    from ..models.params import hummingbird_params, randomize_params
    from ..models.augmented import make_mpc_dynamics
    from ..models.ensemble import GPEnsemble
    from ..ops import MPCConfig, SQPSolver
    from ..loop import EpisodeConfig
    from ..traj import circle_trajectory_accelerating, states_from_flat_outputs

    p1 = hummingbird_params(dtype=dtype)
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p1.hover_input)),
                        log_rgp_posterior=False)  # (B,T,3,nb,nb) off the bench
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p1))
    ts, pos, vel, acc = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=cfg.mpc.dt)
    x_traj = jnp.asarray(states_from_flat_outputs(np.asarray(pos), np.asarray(vel)), dtype)
    T = x_traj.shape[0]
    pb = randomize_params(p1, jax.random.PRNGKey(seed), B)
    x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
    trajb = jnp.broadcast_to(x_traj, (B,) + x_traj.shape)
    gpe = GPEnsemble.fromrange([(-v, v)] * 3, 10, theta=(3.0, 0.1, 0.01), dtype=dtype)
    rgpb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), gpe.state)
    return cfg, solver, (pb, x0, trajb, rgpb), T


def tracking_errors(outs, skip: int = 30):
    """Per-(episode, tick) position error [m] after the first `skip` ticks
    (the spin-up onto the circle)."""
    return np.linalg.norm(
        np.asarray(outs.x_odom)[:, skip:, :3] - np.asarray(outs.x_ref)[:, skip:, :3], axis=2)


def closed_loop(B: int = 1024, v: float = 8.0, t_max: float = 10.0) -> dict:
    """BASELINE config 4: parallel episodes with per-episode RGP state,
    fused update/predict in the control loop."""
    from ..loop import run_episode_batch_fused

    cfg, solver, args, T = closed_loop_setup(B, v, t_max)
    f = jax.jit(lambda p, x, tr, r: run_episode_batch_fused(cfg, solver, p, x, tr, T, r))
    final, outs = f(*args)
    jax.block_until_ready(outs.x_odom)
    t0 = time.perf_counter()
    final, outs = f(*args)
    jax.block_until_ready(outs.x_odom)
    dt = time.perf_counter() - t0
    err = tracking_errors(outs)
    return {
        "metric": "closed-loop learning throughput",
        "episodes": B, "ticks": T,
        "tick_solves_per_s": B * T / dt,
        "err_mean_m": float(err.mean()),
        "err_p95_m": float(np.percentile(err, 95)),
    }


def riccati_crossover(Ns=(10, 20, 40), B: int = 4096, chain: int = 5) -> list:
    """Backend crossover sweep: time per solve as the horizon N grows (fixed
    0.1 s node spacing, B scenarios) for both QP backends of the production
    `solve_batch` path — the condensed IPM ("pdip", O(N^2) memory,
    O((N nu)^3) factorization) and the Riccati IPM ("riccati", O(N)).  Sets
    `ops/sqp.AUTO_RICCATI_MIN_N`.  Each timing is `chain` warm-started solves
    in one dispatch, median of 5 dispatches, compile excluded."""
    from ..models.params import hummingbird_params
    from ..models.augmented import make_mpc_dynamics
    from ..ops import MPCConfig, SQPSolver
    from ..ops.sqp import init_carry

    dtype = jnp.float32
    p = hummingbird_params(dtype=dtype)
    out = []
    for N in Ns:
        row = {"n_nodes": N, "batch": B}
        for method in ("pdip", "riccati"):
            cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N,
                            u_ref=float(p.hover_input), qp_method=method)
            solver = SQPSolver(cfg, make_mpc_dynamics(p))
            x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
            x0 = x0.at[:, 7].add(jnp.linspace(-2, 2, B, dtype=dtype))
            y_ref = jnp.broadcast_to(x0[:, None, :], (B, N, 13))
            carry = jax.vmap(lambda x: init_carry(cfg, x))(x0)

            @jax.jit
            def f(c):
                def body(c, _):
                    c2, sol = solver.solve_batch(c, x0, y_ref, y_ref[:, -1])
                    return c2, sol.cost.sum()
                return jax.lax.scan(body, c, None, length=chain)[1].sum()

            float(f(carry))
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                float(f(carry))
                ts.append(time.perf_counter() - t0)
            row[f"{method}_us_per_solve"] = float(np.median(ts)) / (chain * B) * 1e6
        row["riccati_speedup_vs_pdip"] = (row["pdip_us_per_solve"]
                                          / row["riccati_us_per_solve"])
        print(json.dumps(row), file=sys.stderr, flush=True)
        out.append(row)
    return out


def scaling(n_devices: int, episodes_per_device: int = 8, ticks: int = 10,
            backend=None) -> list:
    """Weak scaling over a dp mesh: fixed per-device work, growing mesh.
    On the CPU backend this exercises the virtual-device mesh for
    CORRECTNESS only (virtual devices share the host's physical cores, so
    the efficiency numbers are meaningless there); on several GPUs the same
    code measures scaling efficiency — the dp pattern has no cross-shard
    communication besides the psum metric reduction, so efficiency on
    hardware is expected near 1."""
    from ..models.params import hummingbird_params
    from ..models.augmented import make_mpc_dynamics
    from ..models.rgp import rgp_init
    from ..ops import MPCConfig, SQPSolver
    from ..loop import EpisodeConfig, run_episode
    from ..parallel import make_mesh, shard_episode_batch, sharded_step_fn

    dtype = jnp.float32
    p = hummingbird_params(dtype=dtype)
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p.hover_input), qp_iters=4))
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p))
    rgp1 = rgp_init(jnp.linspace(-5, 5, 8, dtype=dtype), theta=(3.0, 0.1, 0.01))

    results = []
    base_rate = None
    for nd in range(1, n_devices + 1):
        if len(jax.devices(backend)) < nd:
            break
        B = nd * episodes_per_device
        mesh = make_mesh(nd, backend=backend)
        x0 = jnp.zeros((B, 13), dtype).at[:, 3].set(1.0).at[:, 2].set(3.0)
        traj = jnp.zeros((B, ticks + cfg.mpc.n_nodes, 13), dtype).at[:, :, 3].set(1.0).at[:, :, 2].set(3.0)
        rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)

        def step(batch):
            x0, tr, r = batch
            _, outs = jax.vmap(lambda a, b, rr: run_episode(cfg, solver, p, a, b, ticks, rgp0=rr))(x0, tr, r)
            err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
            return outs.w_odom, {"sq": jnp.sum(err**2)}

        fn = jax.jit(sharded_step_fn(mesh, step))
        batch = shard_episode_batch(mesh, (x0, traj, rgp))
        jax.block_until_ready(fn(batch)[0])
        t0 = time.perf_counter()
        for _ in range(3):
            o, m = fn(batch)
        jax.block_until_ready(o)
        dt = (time.perf_counter() - t0) / 3
        rate = B * ticks / dt
        if base_rate is None:
            base_rate = rate
        results.append({
            "devices": nd, "episodes": B, "tick_solves_per_s": rate,
            "weak_scaling_efficiency": rate / (base_rate * nd),
        })
    return results


def scaling_multiprocess(nproc: int = 2, devices_per_process: int = 4,
                         batch_per_device: int = 128, qp_iters: int = 12,
                         repeats: int = 5) -> dict:
    """Multi-PROCESS weak-scaling harness (BASELINE config 5): spawns
    1..nproc local processes (each with `devices_per_process` virtual CPU
    devices, never a GPU — a card takes one JAX process), runs solve_batch
    over the process-spanning global mesh, and reports throughput + scaling
    efficiency.  The processes share the host's cores, so the efficiency
    NUMBER is meaningless (same caveat as `scaling`) — what this harness
    proves is that the multi-process code path runs and reduces correctly;
    point the same worker at N real hosts for the ≥85% target measurement."""
    from ..parallel.launch import launch_workers

    rows = []
    base = None
    for np_ in range(1, nproc + 1):
        gb = batch_per_device * devices_per_process * np_
        res = launch_workers(nproc=np_, devices_per_process=devices_per_process,
                             global_batch=gb, qp_iters=qp_iters,
                             repeats=repeats)
        rate = float(res[0]["solves_per_sec"])
        if base is None:
            base = rate
        rows.append({"processes": np_, "global_batch": gb,
                     "solves_per_s": rate,
                     "weak_scaling_efficiency": rate / (base * np_)})
    return {"metric": "multi-process weak scaling (CPU correctness harness)",
            "rows": rows,
            "note": "efficiency meaningless on shared-core CPU; harness "
                    "ready for real multi-host hardware"}


def main(argv=None):
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("latency", "throughput", "closed_loop",
                                       "scaling", "riccati_crossover",
                                       "scaling_multiprocess"),
                    default="latency")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size for --what scaling (default: all devices)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU backend; for scaling, spawns --devices virtual devices")
    args = ap.parse_args(argv)
    if args.cpu:
        # must happen before ANY backend initialization
        n = args.devices or 8
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = flags + f" --xla_force_host_platform_device_count={n}"
        jax.config.update("jax_platforms", "cpu")
    if args.devices is None:
        args.devices = len(jax.devices())
    fn = {"latency": latency, "throughput": throughput,
          "closed_loop": closed_loop,
          "riccati_crossover": riccati_crossover,
          "scaling": lambda: scaling(args.devices,
                                     backend="cpu" if args.cpu else None),
          "scaling_multiprocess": scaling_multiprocess}[args.what]
    res = fn()
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
