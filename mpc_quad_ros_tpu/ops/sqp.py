"""SQP-RTI nonlinear MPC over the quadrotor horizon — the acados replacement.

Reproduces the semantics of the reference's acados OCP
(`/root/reference/src/quad_opt.py:89-156`):

- LINEAR_LS cost, W = diag([q_pos(3), q_quat(4), q_vel(3), q_rate(3), r(4)])
  with the reference's quaternion weight-averaging quirk (`quad_opt.py:126`),
  terminal W_e = diag(q) * terminal_cost.
- ERK (single-step RK4) shooting integrator (`solver_options.integrator_type
  = 'ERK'`).
- Gauss-Newton Hessian (exact for LINEAR_LS).
- SQP_RTI: one linearize->QP->update iteration per tick, warm-started from
  the previous solution (no shift — acados' default primal warm start).
- u in [0, 1] box constraints (`quad_opt.py:142-144`), handled by the
  condensed box-QP solvers in `ops/qp.py` (the HPIPM stand-in).

The whole solve is one pure function of (carry, x0, y_ref, model-args).
Linearization uses jacfwd through the RK4 shooting map (replacing CasADi
codegen + acados C sensitivities); full condensing is a scan + einsums; the
QP is a fixed-iteration interior point.  `solve` is one scenario and the
numerical oracle; `solve_batch` runs thousands of scenarios per device with
the same numerics; `lax.scan` chains ticks; shard_map spreads the batch over
a mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import lanes
from .qp import HP, qp_kkt_residual, solve_box_qp_pdip, solve_box_qp_projected_newton

# qp_method="auto": the condensed IPM below this horizon, the O(N) Riccati
# IPM from it on.  On one H100 (`bench.suite.riccati_crossover`, B=4096) the
# condensed IPM, in the form solve_batch dispatches to, was faster at every
# horizon measured (N = 10, 20, 40), so Riccati takes over only past them.
AUTO_RICCATI_MIN_N = 41
# solve_batch runs the condensed backend lanes-last from this batch size on.
# One H100: the vmapped per-scenario `solve` (batched XLA Cholesky) is faster
# at B=1, the lanes-last form from B=128 on (PERF.md).
LANES_MIN_BATCH = 64
# ...and up to this horizon, the longest at which the lanes-last form was
# measured on the card.  At N=40 the vmapped form was 6.5x faster there, and
# the lanes-last Cholesky (unrolled over nz = 4N columns, unpivoted) returned
# NaN in float64 on a scenario the XLA Cholesky solves (PERF.md).
LANES_MAX_N = 20


def _fold_aug(aug):
    """Fold a GP/RGP augmentation into its solve-invariant form (the
    per-solve constant K_x⁻¹ mu_g product) so the RK4 linearization doesn't
    recompute it per stage/tangent.  No-op for None/unknown model pytrees."""
    if aug is None:
        return None
    from ..models.augmented import fold_drag

    return fold_drag(aug)


class MPCConfig(NamedTuple):
    """Static MPC problem definition (hashable — safe as a jit static arg is
    NOT needed; all fields are arrays or Python ints consumed at trace time)."""

    n_nodes: int = 10            # N (`execute_trajectory.py:123`)
    t_horizon: float = 1.0       # [s] (`execute_trajectory.py:122`)
    q_cost: tuple = (10.0, 10.0, 10.0, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05)
    r_cost: tuple = (0.1, 0.1, 0.1, 0.1)
    terminal_cost: float = 1.0   # (`quad_opt.py:44`)
    u_lb: float = 0.0
    u_ub: float = 1.0
    u_ref: float = 0.16          # hover reference control (`quad_opt.py:277,304`)
    sqp_iters: int = 1           # 1 == RTI; >1 == full SQP per tick
    qp_iters: int = 12
    qp_method: str = "pdip"      # "pdip" | "projected_newton" | "riccati" | "auto"
    # "pdip": condensed box-QP interior point (dense nz = N*nu QP);
    # "riccati": sparse Riccati-factorized IPM, O(N) in the horizon;
    # "auto": condensed below AUTO_RICCATI_MIN_N, Riccati from it on.
    shift_warm_start: bool = False
    # False matches acados' default (plain primal warm start, what the
    # reference ran); True shifts the plan one stage per tick (standard RTI
    # practice) — markedly more stable for long horizons on fast references.
    scale_stage_by_dt: bool = True
    # acados integrates the LINEAR_LS Lagrange term over each shooting
    # interval: stage cost x dt, terminal cost unscaled.  Replaying reference
    # logs confirms it (mean |du| vs acados drops 0.024 -> 0.0015 with the
    # scaling on).  Set False for an unscaled discrete-sum cost.
    warm_start_duals: bool = False
    # Carry the IPM dual state (zl, zu) across RTI ticks and seed the QP from
    # it — the role HPIPM's warm start plays inside acados SQP_RTI
    # (`quad_opt.py:147-151`).  MEASURED NEGATIVE on this workload, hence
    # default False: on a 40-tick RTI chain with an aggressive transient
    # (hover -> 4 m step at v=2.5, f32, N=10) the active set flips between
    # ticks and a warm-started IPM crawls along the boundary — max chain KKT
    # 1.0 vs cold 8.1e-4 at 12 iters; centred warm starts (z=0 pushed 0.01
    # into the box, duals mu0/slack) and guarded dual-informed active-set
    # polish steps were also measured and do not beat 12 cold iterations at
    # equal factorization count (cold+polish: KKT unchanged on the hard
    # ticks; see CLAUDE.md numerics notes).  The plumbing is kept because
    # warm starts DO pay on near-steady chains — measured on a 40-tick
    # regulation chain (0.5 m step): warm@6 iters max KKT 4.2e-4 == cold@12's
    # 4.2e-4, warm@8 2.7e-4 < cold@12 — half the factorizations at equal
    # accuracy.  Opt in per deployment after measuring YOUR tick-to-tick
    # active-set churn.

    @property
    def dt(self) -> float:
        return self.t_horizon / self.n_nodes

    @property
    def stage_scale(self) -> float:
        return self.dt if self.scale_stage_by_dt else 1.0

    def q_diagonal(self) -> jnp.ndarray:
        """12 Euler-style weights -> 13 quaternion-state weights with the
        reference's mean-insertion quirk (`quad_opt.py:122-126`)."""
        q = jnp.asarray(self.q_cost)
        return jnp.concatenate([q[:3], jnp.mean(q[3:6])[None], q[3:]])


class SolverCarry(NamedTuple):
    """Warm-started primal trajectory + IPM dual state — the RTI state
    carried across ticks (acados keeps the same pair inside HPIPM)."""

    X: jnp.ndarray  # (N+1, 13)
    U: jnp.ndarray  # (N, 4)
    zl: Optional[jnp.ndarray] = None  # (N*nu,) lower-bound multipliers
    zu: Optional[jnp.ndarray] = None  # (N*nu,) upper-bound multipliers


class MPCSolution(NamedTuple):
    X: jnp.ndarray          # (N+1, 13) QP-updated state trajectory
    U: jnp.ndarray          # (N, 4) optimal controls
    cost: jnp.ndarray       # LS cost of the returned trajectory
    kkt_residual: jnp.ndarray  # projected-gradient norm of the QP solution


def init_carry(cfg: MPCConfig, x0: jnp.ndarray, u0: Optional[jnp.ndarray] = None) -> SolverCarry:
    N = cfg.n_nodes
    X = jnp.broadcast_to(x0, (N + 1,) + x0.shape).astype(x0.dtype)
    if u0 is None:
        u0 = jnp.full((4,), cfg.u_ref, dtype=x0.dtype)
    U = jnp.broadcast_to(u0, (N, 4)).astype(x0.dtype)
    zl = zu = None
    if cfg.warm_start_duals:
        # unit duals == the IPM's cold-start value; the first solve behaves
        # like a (floored) cold start and every later tick inherits real duals
        zl = jnp.ones((N * 4,), dtype=x0.dtype)
        zu = jnp.ones((N * 4,), dtype=x0.dtype)
    return SolverCarry(X=X, U=U, zl=zl, zu=zu)


class SQPSolver:
    """Gauss-Newton SQP(-RTI) on the quadrotor OCP.

    `dynamics`: continuous-time model ẋ = f(x, u, aug) — `aug` is an
    arbitrary pytree of per-tick parameters (e.g. the RGP state whose mu_g
    was updated online), the analogue of acados' runtime parameter vector
    (`quad_opt.py:400-404`) except that here it is just a traced argument,
    so "re-specializing the controller" needs no rebuild (the reference's
    broken `retrain_controller`, `mpc_controller_node.py:410-426`, is free).
    """

    def __init__(self, cfg: MPCConfig, dynamics: Callable):
        self.cfg = cfg
        self.f = dynamics

    # ------------------------------------------------------------------ #
    def discrete_dynamics(self, x: jnp.ndarray, u: jnp.ndarray, dt, aug=None) -> jnp.ndarray:
        """Single RK4 step of the model — `quad_opt.discrete_dynamics`
        (`quad_opt.py:353-377`)."""
        f = lambda xx, uu: self.f(xx, uu, aug)
        k1 = f(x, u)
        k2 = f(x + dt / 2 * k1, u)
        k3 = f(x + dt / 2 * k2, u)
        k4 = f(x + dt * k3, u)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    # ------------------------------------------------------------------ #
    def _linearize(self, X: jnp.ndarray, U: jnp.ndarray, aug):
        """Per-node discretization + sensitivities along the warm-start
        trajectory: x+ = F(x, u), A = dF/dx, B = dF/du, defect r = F(x̄,ū) - x̄+."""
        cfg = self.cfg
        step = lambda x, u: self.discrete_dynamics(x, u, cfg.dt, aug)

        def node(x, u):
            xp = step(x, u)
            A = jax.jacfwd(step, argnums=0)(x, u)
            B = jax.jacfwd(step, argnums=1)(x, u)
            return xp, A, B

        xp, A, B = jax.vmap(node)(X[:-1], U)
        r = xp - X[1:]
        return A, B, r

    # ------------------------------------------------------------------ #
    def _condense(self, A, B, r, dx0):
        """Full condensing: Δx_k = M_k Δu + d_k with
        d_{k+1} = A_k d_k + r_k, M_{k+1} = A_k M_k + B_k E_k.
        Returns M: (N+1, nx, nz), d: (N+1, nx)."""
        N = self.cfg.n_nodes
        nx, nu = A.shape[-1], B.shape[-1]
        nz = N * nu
        dtype = A.dtype

        def body(carry, inp):
            M_k, d_k = carry
            A_k, B_k, r_k, k = inp
            # place B_k into columns [k*nu, (k+1)*nu) — static unroll over k
            E = jnp.zeros((nx, nz), dtype=dtype)
            E = jax.lax.dynamic_update_slice(E, B_k, (0, k * nu))
            M_next = jnp.matmul(A_k, M_k, precision=HP) + E
            d_next = jnp.matmul(A_k, d_k, precision=HP) + r_k
            return (M_next, d_next), (M_next, d_next)

        M0 = jnp.zeros((nx, nz), dtype=dtype)
        (_, _), (M_tail, d_tail) = jax.lax.scan(
            body, (M0, dx0), (A, B, r, jnp.arange(N))
        )
        M = jnp.concatenate([M0[None], M_tail], axis=0)
        d = jnp.concatenate([dx0[None], d_tail], axis=0)
        return M, d

    # ------------------------------------------------------------------ #
    def _resolve_qp_method(self) -> str:
        """Effective QP backend: "auto" picks the condensed IPM below
        AUTO_RICCATI_MIN_N and the O(N) Riccati IPM from it on."""
        m = self.cfg.qp_method
        if m == "auto":
            return "pdip" if self.cfg.n_nodes < AUTO_RICCATI_MIN_N else "riccati"
        return m

    # ------------------------------------------------------------------ #
    def _gn_step(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """One Gauss-Newton iteration: linearize -> condense -> box QP -> update.
        (zl, zu) are the carried IPM duals (None = cold start / not carried);
        returns the post-solve duals alongside the updated trajectory."""
        cfg = self.cfg
        N = cfg.n_nodes
        nu = U.shape[-1]

        method = self._resolve_qp_method()
        if method == "riccati":
            Xn, Un, kkt = self._gn_step_riccati(X, U, x0, y_ref, y_ref_N, aug)
            return Xn, Un, zl, zu, kkt

        H, g, lb, ub, M, d = self._assemble(X, U, x0, y_ref, y_ref_N, aug)

        if method == "pdip":
            if cfg.warm_start_duals and zl is not None:
                z, zl, zu = solve_box_qp_pdip(H, g, lb, ub, iters=cfg.qp_iters,
                                              zl0=zl, zu0=zu, return_duals=True)
            else:
                z = solve_box_qp_pdip(H, g, lb, ub, iters=cfg.qp_iters)
        else:
            z = solve_box_qp_projected_newton(H, g, lb, ub, iters=cfg.qp_iters)

        kkt = qp_kkt_residual(H, g, lb, ub, z)

        U_new = U + z.reshape(N, nu)
        X_new = X + d + jnp.einsum("kxz,z->kx", M, z, precision=HP)
        return X_new, U_new, zl, zu, kkt

    # ------------------------------------------------------------------ #
    def solve(self, carry: SolverCarry, x0: jnp.ndarray, y_ref: jnp.ndarray,
              y_ref_N: jnp.ndarray, aug=None) -> tuple[SolverCarry, MPCSolution]:
        """One MPC solve (the `run_optimization` analogue, `quad_opt.py:321-350`).

        carry   : warm-started primal trajectory (RTI state)
        x0      : (13,) measured state (== the lbx=ubx=x0 pin)
        y_ref   : (N, 13) stage state references (`set_reference_trajectory`)
        y_ref_N : (13,) terminal reference
        aug     : per-tick model parameters (None | RGP state | GP state)
        Returns (next warm-start carry, solution).
        """
        cfg = self.cfg
        aug = _fold_aug(aug)
        X, U, zl, zu = carry.X, carry.U, carry.zl, carry.zu
        if cfg.shift_warm_start:
            X = jnp.concatenate([X[1:], X[-1:]], axis=0)
            U = jnp.concatenate([U[1:], U[-1:]], axis=0)
            if zl is not None:
                nu = U.shape[-1]
                zl = jnp.concatenate([zl[nu:], zl[-nu:]])
                zu = jnp.concatenate([zu[nu:], zu[-nu:]])

        def one_iter(carry_xu, _):
            X, U, zl, zu = carry_xu
            X, U, zl, zu, kkt = self._gn_step(X, U, zl, zu, x0, y_ref, y_ref_N, aug)
            return (X, U, zl, zu), kkt

        (X, U, zl, zu), kkts = jax.lax.scan(
            one_iter, (X, U, zl, zu), None, length=cfg.sqp_iters)

        cost = self.ls_cost(X, U, y_ref, y_ref_N)
        sol = MPCSolution(X=X, U=U, cost=cost, kkt_residual=kkts[-1])
        return SolverCarry(X=X, U=U, zl=zl, zu=zu), sol

    # ------------------------------------------------------------------ #
    def _gn_step_riccati(self, X, U, x0, y_ref, y_ref_N, aug):
        """Gauss-Newton step via the sparse Riccati-factorized interior
        point (`ops/riccati.solve_ocp_box_riccati_ipm`) — O(N) per IPM
        iteration, for long horizons where condensing's dense N*nu QP gets
        expensive.  Box bounds are handled EXACTLY (each IPM Newton system
        is solved by a Riccati sweep with barrier-modified per-stage R_k —
        the same structure HPIPM exploits inside acados,
        `/root/reference/src/quad_opt.py:147-151`); the historical
        feedforward-clamping approximation and its +36% stall on saturated
        instances are gone (`tests/test_riccati.py` pins bound-active N=40
        agreement with the condensed IPM)."""
        from .riccati import solve_ocp_box_riccati_ipm

        cfg = self.cfg
        N = cfg.n_nodes
        nu = U.shape[-1]
        dtype = X.dtype

        q = cfg.q_diagonal().astype(dtype) * cfg.stage_scale
        rw = jnp.asarray(cfg.r_cost, dtype=dtype) * cfg.stage_scale
        p_term_diag = cfg.q_diagonal().astype(dtype) * cfg.terminal_cost

        A, B, r = self._linearize(X, U, aug)
        dx0 = x0 - X[0]

        # stage-k cost references x_k (k = 0..N-1); the k=0 state term is
        # constant w.r.t. the decisions (Δx_0 is pinned) and harmless
        q_lin = q[None, :] * (X[:-1] - y_ref)
        r_lin = rw[None, :] * (U - cfg.u_ref)
        p_term = p_term_diag * (X[N] - y_ref_N)

        dU, dX, _, _ = solve_ocp_box_riccati_ipm(
            A, B, r, q, q_lin, rw, r_lin, p_term_diag, p_term, dx0=dx0,
            u_lb=cfg.u_lb - U, u_ub=cfg.u_ub - U, iters=cfg.qp_iters,
        )
        return self._riccati_finish(U, x0, y_ref, y_ref_N, aug, dU)

    # ------------------------------------------------------------------ #
    def _riccati_finish(self, U, x0, y_ref, y_ref_N, aug, dU):
        """Globalization + honest KKT of the Riccati backend.

        On long horizons a full Newton step from a stale linearization
        diverges (the LQR forward pass extrapolates far outside the
        linearization's validity).  Backtracking line search on the TRUE
        nonlinear-rollout cost, with the accepted trajectory taken from the
        nonlinear rollout (keeps the next linearization consistent).  Fixed
        candidate set -> vmap/scan friendly."""
        cfg = self.cfg
        dtype = U.dtype
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.1], dtype=dtype)

        def rollout(U_c):
            def body(x, u):
                xn = self.discrete_dynamics(x, u, cfg.dt, aug)
                return xn, xn
            _, Xs = jax.lax.scan(body, x0, U_c)
            return jnp.concatenate([x0[None], Xs], axis=0)

        def candidate(alpha):
            U_c = jnp.clip(U + alpha * dU, cfg.u_lb, cfg.u_ub)
            X_c = rollout(U_c)
            return U_c, X_c, self.ls_cost(X_c, U_c, y_ref, y_ref_N)

        U_cand, X_cand, costs = jax.vmap(candidate)(alphas)
        best = jnp.argmin(costs)
        U_best, X_best = U_cand[best], X_cand[best]

        # TRUE projected-gradient KKT residual of the nonlinear problem at the
        # accepted point: grad_U J(U) through the rollout (reverse-mode over
        # the N-step scan), projected onto the u box.  Stronger than the
        # condensed path's QP-subproblem residual — it measures stationarity
        # of the actual returned trajectory, which is the honest metric for a
        # backend whose line search may accept alpha < 1.
        grad_U = jax.grad(
            lambda Uc: self.ls_cost(rollout(Uc), Uc, y_ref, y_ref_N)
        )(U_best)
        proj = jnp.clip(U_best - grad_U, cfg.u_lb, cfg.u_ub) - U_best
        kkt = jnp.max(jnp.abs(proj))
        return X_best, U_best, kkt

    # ------------------------------------------------------------------ #
    def _assemble(self, X, U, x0, y_ref, y_ref_N, aug):
        """Linearize + condense + GN Hessian/gradient for ONE scenario —
        everything except the QP solve of `_gn_step`."""
        A, B, r = self._linearize(X, U, aug)
        return self._cost_from_lin(X, U, x0, y_ref, y_ref_N, A, B, r)

    def _cost_from_lin(self, X, U, x0, y_ref, y_ref_N, A, B, r):
        """Condensing + GN Hessian/gradient from precomputed sensitivities —
        the linearization-independent tail of `_assemble` (vmapped by
        `solve_batch`)."""
        cfg = self.cfg
        N = cfg.n_nodes
        nu = U.shape[-1]
        nz = N * nu
        dtype = X.dtype

        q = cfg.q_diagonal().astype(dtype) * cfg.stage_scale
        rw = jnp.asarray(cfg.r_cost, dtype=dtype) * cfg.stage_scale
        p = cfg.q_diagonal().astype(dtype) * cfg.terminal_cost

        dx0 = x0 - X[0]
        M, d = self._condense(A, B, r, dx0)

        ex = X + d - jnp.concatenate([y_ref, y_ref_N[None]], axis=0)
        eu = U - jnp.full_like(U, cfg.u_ref)

        Mx = M[:N]
        H = jnp.einsum("kxi,x,kxj->ij", Mx, q, Mx, precision=HP) + jnp.einsum(
            "xi,x,xj->ij", M[N], p, M[N], precision=HP
        )
        H = H + jnp.kron(jnp.eye(N, dtype=dtype), jnp.diag(rw))
        # f32 accumulation can leave H asymmetric in the last bits; Cholesky
        # consumers that read full columns (`lanes.box_qp_pdip`) need the
        # symmetric part explicitly (XLA's cholesky reads only the lower
        # triangle, which silently symmetrizes).
        H = 0.5 * (H + H.T)
        g = jnp.einsum("kxi,x,kx->i", Mx, q, ex[:N], precision=HP) + jnp.einsum(
            "xi,x,x->i", M[N], p, ex[N], precision=HP
        )
        g = g + (eu * rw).reshape(nz)

        lb = cfg.u_lb - U.reshape(nz)
        ub = cfg.u_ub - U.reshape(nz)
        return H, g, lb, ub, M, d

    def _linearize_batch(self, X, U, aug):
        """Batched `_linearize`: (A (B,N,13,13), B (B,N,13,4), r (B,N,13)).
        Models with a structure-of-arrays twin (`make_mpc_dynamics`) run
        lanes-last (`lanes.linearize`), every (stage, scenario) column in
        one elementwise sweep; other models vmap jacfwd per scenario."""
        from ..models.augmented import FoldedDrag

        f_soa = getattr(self.f, "soa", None)
        if f_soa is None or not (aug is None or isinstance(aug, FoldedDrag)):
            if aug is None:
                return jax.vmap(lambda X1, U1: self._linearize(X1, U1, None))(X, U)
            return jax.vmap(self._linearize)(X, U, aug)
        last = lambda a: jnp.moveaxis(a, 0, -1)
        aug_l = None if aug is None else jax.tree.map(last, aug)
        J, r = lanes.linearize(f_soa, last(X), last(U), self.cfg.dt, aug_l)
        A = jnp.transpose(J[:13], (3, 2, 1, 0))
        Bm = jnp.transpose(J[13:], (3, 2, 1, 0))
        return A, Bm, jnp.moveaxis(r, -1, 0)

    def _gn_step_batch(self, X, U, zl, zu, x0, y_ref, y_ref_N, aug):
        """Batched `_gn_step` of the condensed IPM: lanes-last linearization,
        vmapped condensing (batched einsums), the lanes-last box QP
        (`lanes.box_qp_pdip`, `ops/qp.py`'s algorithm unrolled over nz),
        then the batch-major expansion dX = d + M z."""
        cfg = self.cfg
        Bsz, N, nu = U.shape
        A, Bm, r = self._linearize_batch(X, U, aug)
        H, g, lb, ub, M, d = jax.vmap(self._cost_from_lin)(
            X, U, x0, y_ref, y_ref_N, A, Bm, r)
        last = lambda a: jnp.moveaxis(a, 0, -1)
        first = lambda a: jnp.moveaxis(a, -1, 0)
        warm = cfg.warm_start_duals and zl is not None
        z, zl_n, zu_n = lanes.box_qp_pdip(
            last(H), last(g), last(lb), last(ub),
            last(zl) if warm else None, last(zu) if warm else None,
            iters=cfg.qp_iters)
        z = first(z)
        if warm:
            zl, zu = first(zl_n), first(zu_n)
        kkt = jax.vmap(qp_kkt_residual)(H, g, lb, ub, z)
        U_new = U + z.reshape(Bsz, N, nu)
        X_new = X + d + jnp.einsum("bkxz,bz->bkx", M, z, precision=HP)
        return X_new, U_new, zl, zu, kkt

    def solve_batch(self, carry: SolverCarry, x0: jnp.ndarray, y_ref: jnp.ndarray,
                    y_ref_N: jnp.ndarray, aug=None) -> tuple[SolverCarry, MPCSolution]:
        """Batch-major solve: all leading dims are the scenario batch B.

        Same algorithm, iteration counts and results (up to f32 rounding) as
        `jax.vmap(self.solve)`, which it is for the Riccati backend, below
        LANES_MIN_BATCH scenarios and past LANES_MAX_N stages; otherwise the
        condensed backend runs its linearization and QP lanes-last
        (`ops/lanes.py`)."""
        cfg = self.cfg
        aug = _fold_aug(aug)
        if (self._resolve_qp_method() != "pdip" or x0.shape[0] < LANES_MIN_BATCH
                or cfg.n_nodes > LANES_MAX_N):
            return jax.vmap(self.solve)(carry, x0, y_ref, y_ref_N, aug)

        def one_iter(c, _):
            X, U, zl, zu, kkt = self._gn_step_batch(*c, x0, y_ref, y_ref_N, aug)
            return (X, U, zl, zu), kkt

        X, U, zl, zu = carry.X, carry.U, carry.zl, carry.zu
        if cfg.shift_warm_start:
            X = jnp.concatenate([X[:, 1:], X[:, -1:]], axis=1)
            U = jnp.concatenate([U[:, 1:], U[:, -1:]], axis=1)
            if zl is not None:
                nu = U.shape[-1]
                zl = jnp.concatenate([zl[:, nu:], zl[:, -nu:]], axis=1)
                zu = jnp.concatenate([zu[:, nu:], zu[:, -nu:]], axis=1)
        (X, U, zl, zu), kkts = jax.lax.scan(
            one_iter, (X, U, zl, zu), None, length=cfg.sqp_iters)
        cost = jax.vmap(self.ls_cost)(X, U, y_ref, y_ref_N)
        sol = MPCSolution(X=X, U=U, cost=cost, kkt_residual=kkts[-1])
        return SolverCarry(X=X, U=U, zl=zl, zu=zu), sol

    # ------------------------------------------------------------------ #
    def ls_cost(self, X, U, y_ref, y_ref_N) -> jnp.ndarray:
        """LINEAR_LS cost value of a trajectory (acados `get_cost` analogue)."""
        cfg = self.cfg
        dtype = X.dtype
        q = cfg.q_diagonal().astype(dtype) * cfg.stage_scale
        rw = jnp.asarray(cfg.r_cost, dtype=dtype) * cfg.stage_scale
        p = cfg.q_diagonal().astype(dtype) * cfg.terminal_cost
        ex = X[:-1] - y_ref
        eu = U - cfg.u_ref
        eN = X[-1] - y_ref_N
        return 0.5 * (
            jnp.sum(ex**2 * q) + jnp.sum(eu**2 * rw) + jnp.sum(eN**2 * p)
        )
