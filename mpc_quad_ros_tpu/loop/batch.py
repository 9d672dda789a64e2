"""Scenario batching: vmapped episodes.

The scaling axis of the framework (SURVEY §2 parallelism inventory): the
reference runs ONE closed loop per process; here a whole batch of episodes —
randomised drag profiles, speeds, trajectories, per-episode RGP state — runs
as a single vmapped scan on one chip, and `parallel/` shards that batch over
a device mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax

from ..models.params import QuadParams
from .episode import EpisodeConfig, run_episode


def run_episode_batch(
    cfg: EpisodeConfig,
    solver,
    plant_params: QuadParams,     # leaves with leading (B,) — per-episode params
    x0,                           # (B, 13)
    x_trajectory,                 # (B, T, 13)
    n_ticks: int,
    rgp0=None,                    # leaves with leading (B,) or None
    gp_aug=None,                  # static pretrained GPState shared by all episodes
):
    """vmap `run_episode` over a leading batch dim of every argument."""

    def one(p, x, traj, rgp):
        return run_episode(cfg, solver, p, x, traj, n_ticks, rgp, gp_aug=gp_aug)

    if rgp0 is None:
        fn = jax.vmap(lambda p, x, tr: one(p, x, tr, None))
        return fn(plant_params, x0, x_trajectory)
    return jax.vmap(one)(plant_params, x0, x_trajectory, rgp0)


def run_episode_batch_fused(
    cfg: EpisodeConfig,
    solver,
    plant_params: QuadParams,     # leaves with leading (B,)
    x0,                           # (B, 13)
    x_trajectory,                 # (B, T, 13)
    n_ticks: int,
    rgp0=None,                    # leaves with leading (B,) or None
    gp_aug=None,                  # static pretrained GPState with leading (B,)
    traj_len=None,                # (B,) int: per-episode valid samples <= T
    episode_ticks=None,           # (B,) int: per-episode tick counts <= n_ticks
):
    """Batch-major episode scan: one scan over ticks whose body operates on
    the WHOLE scenario batch, so the condensed QPs of all episodes are solved
    together by `SQPSolver.solve_batch` (lanes-last from LANES_MIN_BATCH
    episodes on).

    Numerically equivalent to `run_episode_batch` (vmap-of-scan); this is the
    throughput path — the vmap-of-scan form leaves the QP as B independent
    40x40 Cholesky chains.

    HETEROGENEOUS batches (SURVEY §7 "per-episode heterogeneity at scale" —
    mixed v_max means mixed trajectory lengths): pad every trajectory to one
    shared T and pass `traj_len` (B,) with each episode's true sample count;
    the reference gather clips to EACH episode's last valid sample (the
    reference's end-of-trajectory hover padding, `utils.py:912-930`,
    per episode).  `episode_ticks` (B,) additionally FREEZES finished
    episodes: state, solver warm start, and RGP posterior stop evolving, and
    the per-tick `active` mask in the output marks which (episode, tick)
    entries are live — downstream metrics must mask with it (see
    `tracking_rmse_masked`).  Per-episode prefixes match each episode's own
    homogeneous run to chaos-amplified rounding (~1e-3 in position after 30
    ticks: different batch shapes compile to different XLA fusions, whose
    one-ulp reduction-order differences the 12-iter IPM and the closed loop
    amplify — the f32 convergence slack of CLAUDE.md); with IDENTICAL shapes the masked
    path is bitwise-equal to the unmasked one (`tests/test_hetero_batch.py`).

    Returns (final_carry, EpisodeOutput) with leading dims (B, n_ticks, ...).
    """
    import jax.numpy as jnp

    from ..models.dynamics import compute_a_drag_target, plant_substeps
    from ..models.rgp import rgp_regress
    from ..ops.sqp import init_carry
    from .episode import EpisodeCarry, EpisodeOutput

    mpc = cfg.mpc
    N = mpc.n_nodes
    n_sub = cfg.n_substeps
    use_rgp = rgp0 is not None
    log_post = use_rgp and cfg.log_rgp_posterior
    B = x0.shape[0]
    T = x_trajectory.shape[1]
    hetero_T = traj_len is not None
    hetero_ticks = episode_ticks is not None

    def tick(carry, i):
        x = carry.x                                       # (B, 13)
        steps = (i + jnp.arange(N)) * cfg.control_skip    # (N,)
        if hetero_T:
            # clip to each episode's own last valid sample (per-episode
            # end-of-trajectory hover padding)
            idx = jnp.minimum(steps[None, :], (traj_len - 1)[:, None])  # (B, N)
            x_ref = jnp.take_along_axis(x_trajectory, idx[:, :, None], axis=1)
        else:
            idx = jnp.clip(steps, 0, T - 1)
            x_ref = x_trajectory[:, idx, :]               # (B, N, 13)

        aug = carry.rgp if use_rgp else gp_aug
        solver_carry, sol = solver.solve_batch(carry.solver, x, x_ref, x_ref[:, -1], aug)
        u = sol.U[:, 0]                                   # (B, 4)

        x_pred = jax.vmap(lambda x, u: solver.discrete_dynamics(x, u, mpc.dt, None))(x, u)
        x_next = jax.vmap(
            lambda x, u, p: plant_substeps(x, u, p, cfg.simulation_dt, n_sub)
        )(x, u, plant_params)

        if use_rgp:
            v_body, a_drag = compute_a_drag_target(x, carry.x_pred_prev, mpc.dt)
            rgp_new = jax.vmap(jax.vmap(rgp_regress))(
                carry.rgp, v_body[:, :, None], a_drag[:, :, None]
            )
        else:
            v_body = a_drag = None
            rgp_new = carry.rgp

        active = (i < episode_ticks) if hetero_ticks else None  # (B,) bool

        def freeze(new, old):
            """Finished episodes keep their carry unchanged (state frozen,
            solver warm start frozen, RGP posterior stops regressing)."""
            if active is None or new is None:
                return new
            mask = active.reshape((B,) + (1,) * (new.ndim - 1))
            return jnp.where(mask, new, old)

        new_carry = EpisodeCarry(
            x=freeze(x_next, x),
            solver=jax.tree.map(freeze, solver_carry, carry.solver),
            rgp=jax.tree.map(freeze, rgp_new, carry.rgp) if use_rgp else rgp_new,
            x_pred_prev=freeze(x_pred, carry.x_pred_prev),
        )
        out_rgp = new_carry.rgp if use_rgp else None
        out = EpisodeOutput(
            x_odom=x, x_pred_odom=x_pred, x_ref=x_ref[:, 0], w_odom=u,
            cost_solution=sol.cost, kkt_residual=sol.kkt_residual,
            rgp_mu_g_t=out_rgp.mu_g if use_rgp else None,
            v_body=v_body, a_drag=a_drag,
            rgp_basis_vectors=out_rgp.X if log_post else None,
            rgp_C_g_t=out_rgp.C_g if log_post else None,
            rgp_theta=out_rgp.theta if log_post else None,
            active=active,
        )
        return new_carry, out

    carry0 = EpisodeCarry(
        x=x0,
        solver=jax.vmap(lambda x: init_carry(mpc, x))(x0),
        rgp=rgp0,
        x_pred_prev=x0,
    )
    final, outs = jax.lax.scan(tick, carry0, jnp.arange(n_ticks))
    # (n_ticks, B, ...) -> (B, n_ticks, ...) to match run_episode_batch
    outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1) if a is not None else None, outs)
    return final, outs


def tracking_rmse_masked(outs) -> "jax.Array":
    """Per-episode RMS position tracking error over the ACTIVE ticks only —
    the heterogeneous-batch form of `loop.episode.tracking_rmse`."""
    import jax.numpy as jnp

    err2 = jnp.sum((outs.x_odom[..., :3] - outs.x_ref[..., :3]) ** 2, axis=-1)
    if outs.active is None:
        return jnp.sqrt(jnp.mean(err2, axis=-1))
    m = outs.active.astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * m, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1), 1))
