"""Benchmark: batched MPC solves/s on one GPU.

Headline metric per BASELINE.md: batched SQP-RTI MPC solves per second at the
reference operating point (N=10 nodes, 1 s horizon, nx=13, nu=4, u in [0,1],
online-RGP-augmented dynamics with 10 basis vectors/axis, f32, B=65536), plus
the single-vehicle warm-started solve latency (B=1) and closed-loop learning
tick-solves/s (B=16384 episodes).  The reference's implied budget is one
acados solve per 10 ms (100 Hz odometry callback,
`mpc_controller_node.py:116,228`); the BASELINE.json target for this
framework is >= 10,000 solves/s per host.

Prints ONE JSON line naming the device it ran on.  Exits non-zero when JAX
finds no GPU: a CPU number is never reported as a device number."""

import json
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from mpc_quad_ros_tpu.io.compile_cache import enable_compile_cache


def main():
    from mpc_quad_ros_tpu.bench.suite import closed_loop, operating_point

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()

    B = int(os.environ.get("BENCH_BATCH", 65536))
    iters = int(os.environ.get("BENCH_ITERS", 20))

    solver, carry, x0, y_ref, rgp = operating_point(B)

    @jax.jit
    def chained_solves(carry, x0, y_ref, rgp):
        # `iters` warm-started solves chained in ONE dispatch (a lax.scan,
        # exactly how the closed-loop episode drives the solver)
        def body(c, _):
            c2, sol = solver.solve_batch(c, x0, y_ref, y_ref[:, -1], rgp)
            return c2, sol.cost.sum()
        return jax.lax.scan(body, carry, None, length=iters)

    # compile + warmup
    c, costs = chained_solves(carry, x0, y_ref, rgp)
    jax.block_until_ready(costs)

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        c, costs = chained_solves(carry, x0, y_ref, rgp)
        jax.block_until_ready(costs)
    dt = time.perf_counter() - t0

    solves_per_s = B * iters * reps / dt

    # --- latency percentiles of one warm-started solve (B=1), K solves ---
    # --- chained per dispatch ---
    carry1 = jax.tree.map(lambda a: a[:1], carry)
    x01, y_ref1 = x0[:1], y_ref[:1]
    rgp1b = jax.tree.map(lambda a: a[:1], rgp)
    K = 50

    @jax.jit
    def chain1(c, x, yr, r):
        def body(c, _):
            c2, sol = solver.solve_batch(c, x, yr, yr[:, -1], r)
            return c2, sol.cost.sum()
        return jax.lax.scan(body, c, None, length=K)

    jax.block_until_ready(chain1(carry1, x01, y_ref1, rgp1b)[1])
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(chain1(carry1, x01, y_ref1, rgp1b)[1])
        lat.append((time.perf_counter() - t0) / K * 1e3)
    lat.sort()
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]

    # --- BASELINE config 4: closed-loop learning at scale — B parallel ---
    # --- episodes with per-episode RGP state, fused update/predict/tick ---
    closed = {}
    if os.environ.get("BENCH_SKIP_CLOSED") != "1":
        cb = int(os.environ.get("BENCH_CLOSED_B", 16384))
        cl = closed_loop(B=cb, v=8.0, t_max=10.0)
        closed = {
            "closed_loop_tick_solves_per_s": round(cl["tick_solves_per_s"], 1),
            "closed_loop_episodes": cl["episodes"],
            "closed_loop_ticks": cl["ticks"],
            "closed_loop_err_mean_m": round(cl["err_mean_m"], 4),
            "closed_loop_err_p95_m": round(cl["err_p95_m"], 4),
        }

    print(
        json.dumps(
            {
                "metric": "batched MPC solves/s (N=10, RGP-augmented, 1 chip)",
                "value": round(solves_per_s, 1),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / 10000.0, 3),
                "latency_p50_ms": round(p50, 3),
                "latency_p99_ms": round(p99, 3),
                "latency_budget_ms": 10.0,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                **closed,
            }
        )
    )


if __name__ == "__main__":
    main()
