"""Smoke run of the MPC system's main path, compiled for the GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --multichip   # four cards: the sharded `dp` path only

One-card phases, each compiled for the card (compile time reported apart from
run time), with `compiled.memory_analysis()` of its step, and each checked
against the plain reference — `SQPSolver.solve` at float64 on the CPU device
of this same process, x64 switched on only around the reference:

  open_loop    `solve_batch` at the benchmark operating point (N=10, 1 s
               horizon, RGP with 10 basis vectors per axis, f32), B=65536
  single       one vehicle (B=1), 50 warm-started solves chained in one scan
  closed_loop  `run_episode_batch_fused`, B=16384 episodes, v=8 m/s, 10 s:
               MPC solve + 20 RK4 plant substeps + RGP regress per tick
  cli          `run.run_sim` as `--gpe 2 --trajectory 2 --v_max 10 --a_max 10`,
               one episode and `--batch 4096`

Bounds: on scenarios near hover the f32 controls stay within 1e-2 of the f64
reference and the QP KKT residual within 5e-4.  At the aggressive operating
point the f32 algorithm's own floor exceeds both on any device, so there the
card may exceed the reference by no more than those bounds beyond the same
program run in f32 on the CPU (PERF.md, "Bring-up findings").  Closed loops:
mean tracking error within 0.05 m of the f64 run of the same episodes, all
states finite.

Exits non-zero without a GPU, and when any phase fails; the last line of
stdout is then never the result object.  Only this process opens the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

U_BOUND, KKT_BOUND, TRACK_BOUND = 1e-2, 5e-4, 0.05
SAMPLE = 512


def _say(msg):
    print(msg, flush=True)


def _compile(fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = None if ma is None else {
        "temp_MiB": round(ma.temp_size_in_bytes / 2**20, 1),
        "args_MiB": round(ma.argument_size_in_bytes / 2**20, 1),
        "out_MiB": round(ma.output_size_in_bytes / 2**20, 1)}
    return compiled, t_compile, mem


def _time(compiled, *args, reps=5):
    import jax

    out = compiled(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = compiled(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def _on_cpu(fn, tree, dtype):
    """fn(tree) on the CPU device with every leaf cast to `dtype` (x64 on
    only for float64)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(dtype == np.float64), jax.default_device(jax.devices("cpu")[0]):
        cast = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), tree)
        return jax.tree.map(np.asarray, fn(cast))


def _solver_for(dtype):
    import jax.numpy as jnp

    from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics
    from mpc_quad_ros_tpu.models.params import hummingbird_params
    from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver

    p = hummingbird_params(dtype=jnp.dtype(dtype))
    return SQPSolver(MPCConfig(u_ref=float(p.hover_input)), make_mpc_dynamics(p))


def _reference_solves(inputs, chain):
    """(U, kkt) of `chain` warm-started `SQPSolver.solve`s per scenario, at
    float64 (the reference) and float32 (the algorithm's own f32 floor),
    both on the CPU."""
    import jax

    out = {}
    for dt in (np.float64, np.float32):
        def run(t):
            s = _solver_for(dt)
            c, x, yr, r = t

            def one(c, x, yr, r):
                def body(c, _):
                    c2, sol = s.solve(c, x, yr, yr[-1], r)
                    return c2, sol
                _, sols = jax.lax.scan(body, c, None, length=chain)
                return sols.U[-1], sols.kkt_residual[-1]
            return jax.jit(jax.vmap(one))(c, x, yr, r)

        out[dt] = _on_cpu(run, inputs, dt)
    return out


def _check_solves(name, U, kkt, inputs, chain, near_hover, ref=None):
    """Compare card results on the sampled scenarios with the reference."""
    ref = ref or _reference_solves(inputs, chain)
    U64, _ = ref[np.float64]
    U32, kkt32 = ref[np.float32]
    err = float(np.abs(np.asarray(U, np.float64) - U64).max())
    kkt_max = float(np.max(kkt))
    floor_err = float(np.abs(U32.astype(np.float64) - U64).max())
    floor_kkt = float(np.max(kkt32))
    if near_hover:
        u_lim, k_lim = U_BOUND, KKT_BOUND
    else:
        u_lim, k_lim = floor_err + U_BOUND, floor_kkt + KKT_BOUND
    ok = bool(np.isfinite(U).all()) and err <= u_lim and kkt_max <= k_lim
    return ok, {f"{name}.max_dU_vs_f64": err, f"{name}.dU_limit": u_lim,
                f"{name}.kkt_max": kkt_max, f"{name}.kkt_limit": k_lim,
                f"{name}.cpu_f32_dU_vs_f64": floor_err,
                f"{name}.cpu_f32_kkt_max": floor_kkt}


def _peak_mib():
    import jax

    stats = jax.devices()[0].memory_stats()     # None on the CPU
    return None if stats is None else round(stats["peak_bytes_in_use"] / 2**20, 1)


def _sample(tree, idx):
    import jax

    return jax.tree.map(lambda a: np.asarray(a)[idx], tree)


def phase_open_loop(B=65536, seed=0):
    from mpc_quad_ros_tpu.bench.suite import operating_point

    solver, carry, x0, y_ref, rgp = operating_point(B, seed)
    step = lambda c, x, yr, r: solver.solve_batch(c, x, yr, yr[:, -1], r)[1]
    compiled, t_c, mem = _compile(step, carry, x0, y_ref, rgp)
    sol, t_run = _time(compiled, carry, x0, y_ref, rgp)
    idx = np.random.default_rng(seed).choice(B, size=min(B, SAMPLE), replace=False)
    res = {"B": B, "compile_s": t_c, "run_ms": t_run * 1e3,
           "solves_per_s": B / t_run, "memory": mem,
           "shape_ok": tuple(sol.U.shape) == (B, 10, 4)}
    ok_a, r_a = _check_solves("operating_point", np.asarray(sol.U)[idx],
                              np.asarray(sol.kkt_residual)[idx],
                              _sample((carry, x0, y_ref, rgp), idx), 1, False)
    # near hover, through the same compiled step
    solver, carry, x0, y_ref, rgp = operating_point(B, seed, vel=0.25, ramp=(0.0, 0.25))
    sol = compiled(carry, x0, y_ref, rgp)
    ok_b, r_b = _check_solves("near_hover", np.asarray(sol.U)[idx],
                              np.asarray(sol.kkt_residual)[idx],
                              _sample((carry, x0, y_ref, rgp), idx), 1, True)
    return ok_a and ok_b and res["shape_ok"], {**res, **r_a, **r_b}


def phase_single(K=50, seed=0):
    import jax

    from mpc_quad_ros_tpu.bench.suite import operating_point

    res, ok = {"B": 1, "chain": K}, True
    for name, kw in (("operating_point", {}),
                     ("near_hover", {"vel": 0.25, "ramp": (0.0, 0.25)})):
        solver, carry, x0, y_ref, rgp = operating_point(1, seed, **kw)

        def chain(c, x, yr, r):
            def body(c, _):
                c2, sol = solver.solve_batch(c, x, yr, yr[:, -1], r)
                return c2, sol
            return jax.lax.scan(body, c, None, length=K)[1]

        if name == "operating_point":
            compiled, t_c, mem = _compile(chain, carry, x0, y_ref, rgp)
            sols, t_run = _time(compiled, carry, x0, y_ref, rgp)
            res.update(compile_s=t_c, ms_per_solve=t_run / K * 1e3, memory=mem)
        else:
            sols = compiled(carry, x0, y_ref, rgp)
        ok_i, r_i = _check_solves(name, np.asarray(sols.U[-1]), np.asarray(sols.kkt_residual[-1]),
                                  (carry, x0, y_ref, rgp), K, name == "near_hover")
        ok, res = ok and ok_i, {**res, **r_i}
    return ok, res


def _track_mean(outs):
    from mpc_quad_ros_tpu.bench.suite import tracking_errors

    return float(tracking_errors(outs).mean())


def _closed_loop_reference(args, T, v=8.0, t_max=10.0):
    """`run_episode_batch_fused` on the episodes `args` at float64 on the CPU."""
    import jax

    from mpc_quad_ros_tpu.bench.suite import closed_loop_setup
    from mpc_quad_ros_tpu.loop import run_episode_batch_fused

    def reference(a):
        cfg64, solver64, _, _ = closed_loop_setup(1, v, t_max, dtype=np.float64)
        return jax.jit(lambda p, x, tr, r: run_episode_batch_fused(
            cfg64, solver64, p, x, tr, T, r)[1])(*a)

    return _on_cpu(reference, args, np.float64)


def phase_closed_loop(B=16384, v=8.0, t_max=10.0, n_ref=8):
    import jax

    from mpc_quad_ros_tpu.bench.suite import closed_loop_setup
    from mpc_quad_ros_tpu.loop import run_episode_batch_fused

    cfg, solver, args, T = closed_loop_setup(B, v, t_max)
    run = lambda p, x, tr, r: run_episode_batch_fused(cfg, solver, p, x, tr, T, r)[1]
    compiled, t_c, mem = _compile(run, *args)
    t0 = time.perf_counter()
    outs = compiled(*args)
    jax.block_until_ready(outs.x_odom)
    t_run = time.perf_counter() - t0
    finite = bool(np.isfinite(np.asarray(outs.x_odom)).all())
    err_card = _track_mean(jax.tree.map(lambda a: None if a is None else a[:n_ref], outs))
    err_ref = _track_mean(_closed_loop_reference(_sample(args, slice(0, n_ref)), T, v, t_max))
    ok = finite and abs(err_card - err_ref) <= TRACK_BOUND
    return ok, {"B": B, "ticks": T, "compile_s": t_c, "run_s": t_run,
                "tick_solves_per_s": B * T / t_run, "memory": mem,
                "states_finite": finite, "err_mean_all_m": _track_mean(outs),
                f"err_mean_first{n_ref}_m": err_card,
                f"err_mean_first{n_ref}_f64_cpu_m": err_ref, "limit_m": TRACK_BOUND}


def _cli_reference(cfg, n_ref):
    """The first `n_ref` episodes of `run_sim(cfg)` at float64 on the CPU,
    through the per-scenario episode loop, with the same (f32-drawn) plant
    randomization as the card run."""
    import jax

    from mpc_quad_ros_tpu.loop import run_episode_batch
    from mpc_quad_ros_tpu.models.params import randomize_params
    from mpc_quad_ros_tpu.run import build_sim

    _, _, p32, *_ = build_sim(cfg, np.float32)
    pb = randomize_params(p32, jax.random.PRNGKey(cfg.seed), n_ref)

    def run(pb):
        ecfg, solver, p, x0, x_traj, _, rgp0, _ = build_sim(cfg, np.float64)
        b = lambda a: jax.numpy.broadcast_to(a, (n_ref,) + a.shape)
        return jax.jit(lambda pb: run_episode_batch(
            ecfg, solver, pb, b(x0), b(x_traj), x_traj.shape[0],
            jax.tree.map(b, rgp0))[1])(pb)

    if cfg.batch == 1:
        pb = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a)[None], (n_ref,) + a.shape), p32)
    return _on_cpu(run, pb, np.float64)


def phase_cli(batch):
    import jax

    from mpc_quad_ros_tpu.io.config import SimConfig
    from mpc_quad_ros_tpu.loop.episode import tracking_rmse
    from mpc_quad_ros_tpu.run import run_sim

    cfg = SimConfig(gpe=2, trajectory=2, v_max=10.0, a_max=10.0, batch=batch)
    t0 = time.perf_counter()
    _, outs, extras = run_sim(cfg, verbose=False)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, outs, extras = run_sim(cfg, verbose=False)
    t_second = time.perf_counter() - t0
    n_ref = 1 if batch == 1 else 8
    ref = _cli_reference(cfg, n_ref)
    rmse = np.atleast_1d(np.asarray(extras["rmse"], np.float64))
    rmse_ref = np.asarray(tracking_rmse(ref))
    finite = bool(np.isfinite(np.asarray(outs.x_odom)).all())
    diff = abs(float(rmse[:n_ref].mean()) - float(rmse_ref.mean()))
    ok = finite and diff <= TRACK_BOUND
    return ok, {"batch": batch, "ticks": int(np.asarray(outs.x_odom).shape[-2]),
                "first_call_s_with_compile": t_first, "second_call_s": t_second,
                "states_finite": finite, "rmse_mean_m": float(rmse.mean()),
                f"rmse_mean_first{n_ref}_m": float(rmse[:n_ref].mean()),
                f"rmse_mean_first{n_ref}_f64_cpu_m": float(rmse_ref.mean()),
                "limit_m": TRACK_BOUND,
                "peak_MiB": _peak_mib()}


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def phase_multichip(mesh, per_device=16384, n_ref=8):
    """The `dp` mesh over four cards: sharded `solve_batch` and sharded
    closed-loop learning on B = 4 x `per_device` scenarios, against the same
    batch on one card and against the f64 reference.

    Open loop, per scenario: near hover the sharded U match one card within
    1e-2, and both runs meet the fixed bounds against f64; at the operating
    point both meet the same limits as `phase_open_loop`.  Closed loop: every
    episode's tracking error within 0.05 m of its one-card run, and a seeded
    sample of `n_ref` episodes within 0.05 m of their f64 runs.  The psum'd
    metrics match the one-card sums.  The largest per-scenario differences of
    controls between the two runs are reported: f32 results depend on the
    batch width XLA compiles for, and the IPM amplifies the rounding where
    bounds are active (PERF.md)."""
    import jax
    import jax.numpy as jnp

    from mpc_quad_ros_tpu.bench.suite import closed_loop_setup, operating_point, tracking_errors
    from mpc_quad_ros_tpu.loop import run_episode_batch_fused
    from mpc_quad_ros_tpu.parallel import shard_episode_batch, sharded_step_fn

    n = mesh.devices.size
    B = n * per_device
    one = mesh.devices.flat[0]
    rng = np.random.default_rng(0)
    res = {"devices": n, "B": B}

    def both(fn, batch, reps):
        """fn on the mesh (compiled, timed) and on one card."""
        compiled, t_c, mem = _compile(sharded_step_fn(mesh, fn), shard_episode_batch(mesh, batch))
        (outs, metrics), t_run = _time(compiled, shard_episode_batch(mesh, batch), reps=reps)
        outs1, metrics1 = jax.jit(fn)(jax.device_put(batch, one))
        return (jax.tree.map(np.asarray, outs), metrics, jax.tree.map(np.asarray, outs1),
                metrics1, t_c, t_run, mem)

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def solve(b):
        c, x, yr, r = b
        sol = solver.solve_batch(c, x, yr, yr[:, -1], r)[1]
        return (sol.U, sol.kkt_residual), {
            "cost_sum": jnp.sum(sol.cost), "n": jnp.asarray(x.shape[0], jnp.float32)}

    idx = rng.choice(B, size=min(B, SAMPLE), replace=False)
    ok = True
    for name, kw in (("operating_point", {}),
                     ("near_hover", {"vel": 0.25, "ramp": (0.0, 0.25)})):
        solver, *batch = operating_point(B, **kw)
        (U_sh, k_sh), m_sh, (U_1, k_1), m_1, t_c, t_run, mem = both(solve, batch, 5)
        near = name == "near_hover"
        ref = _reference_solves(_sample(batch, idx), 1)
        ok_sh, r_sh = _check_solves(f"solve.{name}.sharded", U_sh[idx], k_sh[idx], None, 1, near, ref)
        ok_1, r_1 = _check_solves(f"solve.{name}.one_card", U_1[idx], k_1[idx], None, 1, near, ref)
        dU, rel_cost = _max_diff(U_sh, U_1), rel(m_sh["cost_sum"], m_1["cost_sum"])
        ok = (ok and ok_sh and ok_1 and rel_cost <= 1e-3 and float(m_sh["n"]) == B
              and (dU <= U_BOUND or not near))
        if not near:
            res.update({"solve.compile_s": t_c, "solve.run_ms": t_run * 1e3,
                        "solve.solves_per_s": B / t_run, "solve.memory": mem})
        res.update({f"solve.{name}.max_dU_sharded_vs_one_card": dU,
                    f"solve.{name}.rel_diff_cost_sum": rel_cost, **r_sh, **r_1})
    res["solve.near_hover.dU_sharded_vs_one_card_limit"] = U_BOUND

    cfg, solver, args, T = closed_loop_setup(B)

    def episodes(b):
        p, x, tr, r = b
        outs = run_episode_batch_fused(cfg, solver, p, x, tr, T, r)[1]
        err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
        small = outs._replace(x_pred_odom=None, rgp_mu_g_t=None, v_body=None, a_drag=None)
        return small, {"sq_err_sum": jnp.sum(err**2), "kkt_sum": jnp.sum(outs.kkt_residual),
                       "episodes": jnp.asarray(x.shape[0], jnp.float32)}

    o_sh, e_sh, o_1, e_1, t_c, t_run, mem = both(episodes, args, 2)
    errs = lambda outs: tracking_errors(outs).mean(axis=1)   # per episode [m]
    err_sh = errs(o_sh)
    finite = bool(np.isfinite(o_sh.x_odom).all())
    pick = np.sort(rng.choice(B, size=n_ref, replace=False))
    d_ref = float(np.abs(err_sh[pick] - errs(_closed_loop_reference(_sample(args, pick), T))).max())
    d_err = float(np.abs(err_sh - errs(o_1)).max())
    rel_err = rel(e_sh["sq_err_sum"], e_1["sq_err_sum"])
    ok = (ok and finite and d_ref <= TRACK_BOUND and d_err <= TRACK_BOUND
          and rel_err <= 1e-3 and float(e_sh["episodes"]) == B)
    res.update({"closed_loop.ticks": T, "closed_loop.compile_s": t_c,
                "closed_loop.run_s": t_run, "closed_loop.tick_solves_per_s": B * T / t_run,
                "closed_loop.memory": mem, "closed_loop.states_finite": finite,
                f"closed_loop.sample{n_ref}_max_derr_vs_f64_m": d_ref,
                "closed_loop.max_derr_sharded_vs_one_card_m": d_err,
                "closed_loop.err_limit_m": TRACK_BOUND,
                "closed_loop.max_dW_sharded_vs_one_card": _max_diff(o_sh.w_odom, o_1.w_odom),
                "closed_loop.rel_diff_sq_err_sum": rel_err,
                "closed_loop.kkt_sum_sharded": float(e_sh["kkt_sum"]),
                "closed_loop.kkt_sum_one_card": float(e_1["kkt_sum"])})
    return ok, res


def _gpu_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card dp-mesh phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpc_quad_ros_tpu.io.compile_cache import enable_compile_cache

    enable_compile_cache()
    _say(f"gpu: {_gpu_line()}")
    _say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    if args.multichip:
        if len(devs) < 4:
            print(f"chip_smoke --multichip: needs 4 GPUs, found {len(devs)}", file=sys.stderr)
            return 2
        from mpc_quad_ros_tpu.parallel import make_mesh

        mesh = make_mesh(4)
        phases = [("multichip", lambda: phase_multichip(mesh))]
    else:
        phases = [("open_loop", phase_open_loop), ("single", phase_single),
                  ("closed_loop", phase_closed_loop),
                  ("cli_single", lambda: phase_cli(1)),
                  ("cli_batch", lambda: phase_cli(4096))]
    all_ok = True
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        ok, res = fn()
        res["phase_wall_s"] = time.perf_counter() - t0
        _say(f"phase {name}: {'PASS' if ok else 'FAIL'} {json.dumps(res)}")
        all_ok = all_ok and ok
    _say(f"total wall {time.perf_counter() - t_all:.1f} s")
    if not all_ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
