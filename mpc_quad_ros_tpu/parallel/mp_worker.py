"""Multi-process SPMD worker: one process of the multi-host scenario farm.

Run one copy per host (or per local test process):

    python -m mpc_quad_ros_tpu.parallel.mp_worker \
        --coordinator 10.0.0.1:9876 --num-processes 2 --process-id 0 \
        --global-batch 1024 --out /tmp/shard0.npz

Every process executes the SAME program (jax multi-controller SPMD): it
materializes only its own contiguous scenario slice, joins the global mesh,
and runs the batched `solve_batch` path plus a closed-loop learning step
under `shard_map`, with `psum`-reduced global metrics (the BASELINE
config-5 "QP reductions + convergence checks" across hosts).  The CPU test
harness (`tests/test_multiprocess.py`, `parallel/launch.py`) spawns N local
processes x K virtual devices over localhost gloo; on GPU hosts the same
file runs with one process per host and no --platform flag.

Input construction is deterministic in the GLOBAL scenario index (pure
numpy, `build_inputs`), so the single-process oracle in the test builds
bit-identical scenarios without any cross-process communication.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_inputs(global_B: int, n_nodes: int = 10, nb: int = 10,
                 dtype=np.float32):
    """Deterministic global scenario set: hover states with a per-scenario
    velocity offset and a shifted position reference.  Pure numpy keyed only
    by the global index — every process (and the oracle) reproduces any
    slice bit-identically."""
    i = np.arange(global_B, dtype=np.float64)
    x0 = np.zeros((global_B, 13), dtype)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7] = np.asarray(np.sin(0.7 * i) * 1.5, dtype)
    x0[:, 8] = np.asarray(np.cos(1.3 * i) * 1.0, dtype)
    ref = x0.copy()
    ref[:, 0] += np.asarray(0.25 + 0.5 * np.sin(0.3 * i), dtype)
    y_ref = np.broadcast_to(ref[:, None, :], (global_B, n_nodes, 13)).copy()
    return x0, y_ref, ref


def run_worker(num_processes: int, process_id: int, coordinator: str,
               global_batch: int, qp_iters: int, out_path: str | None,
               devices_per_process: int | None = None,
               platform: str | None = None, ticks: int = 0,
               repeats: int = 1, chain: int = 1):
    """Body of one SPMD worker; returns the result dict it also saves."""
    # --- runtime wiring (env flags must precede backend init) ---
    if devices_per_process is not None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={devices_per_process}").strip()
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp

    from .distributed import (global_mesh, initialize, local_shard,
                              make_global_batch, process_slice)
    from .mesh import sharded_step_fn

    initialize(coordinator_address=coordinator, num_processes=num_processes,
               process_id=process_id)
    mesh = global_mesh()
    n_dev = mesh.devices.size

    from ..models.augmented import make_mpc_dynamics
    from ..models.params import hummingbird_params
    from ..models.rgp import rgp_init
    from ..ops import MPCConfig, SQPSolver
    from ..ops.sqp import init_carry

    dtype = jnp.float32
    p = hummingbird_params(dtype=dtype)
    cfg = MPCConfig(u_ref=float(p.hover_input), qp_iters=qp_iters)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(jnp.linspace(-10, 10, 10, dtype=dtype),
                    theta=(3.0, 0.1, 0.01))

    # --- this process's scenario slice only ---
    x0_g, y_ref_g, ref_g = build_inputs(global_batch, cfg.n_nodes)
    sl = process_slice(global_batch)
    x0_l, y_ref_l, ref_l = x0_g[sl], y_ref_g[sl], ref_g[sl]
    B_l = x0_l.shape[0]
    carry_l = jax.vmap(lambda x: init_carry(cfg, x))(jnp.asarray(x0_l))
    rgp_l = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a), (B_l, 3) + a.shape).copy(), rgp1)

    batch = make_global_batch(
        mesh, (jax.tree.map(np.asarray, carry_l._asdict()), x0_l, y_ref_l,
               ref_l, rgp_l))

    def step(b):
        carry_d, x0, y_ref, ref, rgp = b
        from ..ops.sqp import SolverCarry
        carry = SolverCarry(**carry_d)
        # `chain` WARM-STARTED RTI solves back-to-back (the production tick
        # chain — each solve re-solves from the previous solution under the
        # process-spanning mesh); chain=1 is a single cold solve
        sol = None
        for _ in range(max(chain, 1)):
            carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
        metrics = {
            "kkt_sum": jnp.sum(sol.kkt_residual),
            "cost_sum": jnp.sum(sol.cost),
            "n": jnp.asarray(float(x0.shape[0]), jnp.float32),
        }
        return (sol.U, sol.cost, sol.kkt_residual), metrics

    sharded = jax.jit(sharded_step_fn(mesh, step))
    (U, cost, kkt), metrics = sharded(batch)
    jax.block_until_ready(U)

    # throughput measurement (repeats > 1: scaling harness mode)
    elapsed = None
    if repeats > 1:
        import time
        t0 = time.perf_counter()
        for _ in range(repeats):
            (U, cost, kkt), metrics = sharded(batch)
        jax.block_until_ready(U)
        elapsed = (time.perf_counter() - t0) / repeats

    result = {
        "U_local": local_shard(U),
        "cost_local": local_shard(cost),
        "kkt_sum": float(metrics["kkt_sum"]),
        "cost_sum": float(metrics["cost_sum"]),
        "n": float(metrics["n"]),
        "process_id": process_id,
        "num_processes": num_processes,
        "n_devices_global": n_dev,
        "slice_start": sl.start,
    }
    if elapsed is not None:
        result["sec_per_step"] = elapsed
        result["solves_per_sec"] = global_batch / elapsed

    # --- optional closed-loop learning leg (run_episode under the mesh) ---
    if ticks > 0:
        from ..loop import EpisodeConfig, run_episode

        ecfg = EpisodeConfig(mpc=cfg)
        T = 6
        xt_l = np.zeros((B_l, T, 13), np.float32)
        xt_l[:, :, 3] = 1.0
        xt_l[:, :, 2] = 3.0
        xt_l[:, :, 0] = np.linspace(0, 1, T, dtype=np.float32)[None, :]

        def ep_step(b):
            x0, traj, rgp = b
            final, outs = jax.vmap(
                lambda a, t, r: run_episode(ecfg, solver, p, a, t, ticks, rgp0=r)
            )(x0, traj, rgp)
            err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
            return outs.x_odom, {"ep_sq_err_sum": jnp.sum(err**2),
                                 "ep_n": jnp.asarray(float(x0.shape[0]),
                                                     jnp.float32)}

        ep_batch = make_global_batch(mesh, (x0_l, xt_l, rgp_l))
        ep_sharded = jax.jit(sharded_step_fn(mesh, ep_step))
        x_hist, ep_metrics = ep_sharded(ep_batch)
        jax.block_until_ready(x_hist)
        result["ep_x_local"] = local_shard(x_hist)
        result["ep_sq_err_sum"] = float(ep_metrics["ep_sq_err_sum"])
        result["ep_n"] = float(ep_metrics["ep_n"])

    if out_path:
        np.savez(out_path, **result)
    print(f"[mp_worker {process_id}/{num_processes}] OK: "
          f"{n_dev} global devices, local B={B_l}, "
          f"kkt_sum={result['kkt_sum']:.3e}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--qp-iters", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=0,
                    help="closed-loop MPC ticks for the episode leg (0=skip)")
    ap.add_argument("--repeats", type=int, default=1,
                    help=">1: time the solve step (scaling harness mode)")
    ap.add_argument("--chain", type=int, default=1,
                    help="warm-started RTI solves chained per step")
    ap.add_argument("--devices-per-process", type=int, default=None,
                    help="CPU testing: virtual device count for this process")
    ap.add_argument("--platform", default=None,
                    help="force jax platform (CPU testing: 'cpu')")
    ap.add_argument("--out", default=None, help="npz output path")
    a = ap.parse_args(argv)
    run_worker(a.num_processes, a.process_id, a.coordinator, a.global_batch,
               a.qp_iters, a.out, a.devices_per_process, a.platform,
               a.ticks, a.repeats, a.chain)


if __name__ == "__main__":
    main()
