"""Box-constrained dense QP solvers — the replacement for HPIPM.

The reference delegates its condensed OCP QPs to acados' FULL_CONDENSING_HPIPM
(C interior-point, `quad_opt.py:147`).  Here the condensed QP

    min_z  1/2 zᵀ H z + gᵀ z   s.t.  lb <= z <= ub        (z = Δu, nz = N*nu)

is solved by fixed-iteration methods with NO data-dependent control flow, so a
single jit trace vmaps over thousands of scenarios and shards over a mesh
(one slow scenario cannot stall a lane — iteration counts are static;
SURVEY §7 "hard parts").

Two methods:

- `solve_box_qp_pdip`      : primal-dual interior point with Mehrotra-style
                             centering, fixed iteration count.  Robust default,
                             mirrors HPIPM's algorithm family.
- `solve_box_qp_projected_newton` : Bertsekas projected Newton on the active
                             set (masked KKT solve).  Finite-terminating on
                             these small boxes, cheaper per iteration.

Both batch all linear algebra (Cholesky of nz x nz) so XLA lowers them to
batched factorizations under vmap; `ops/lanes.box_qp_pdip` is the first one
run lanes-last for large batches.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# f32 products at full precision: a GPU would otherwise run them in TF32
HP = jax.lax.Precision.HIGHEST


def _sym_solve(M: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve M x = rhs for symmetric positive definite M via Cholesky."""
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


WS_GAMMA = 0.01   # warm-start primal interiority margin (fraction of box width)
WS_FLOOR = 1e-3   # warm-start dual floor


@partial(jax.jit, static_argnames=("iters", "return_duals"))
def solve_box_qp_pdip(H: jnp.ndarray, g: jnp.ndarray, lb: jnp.ndarray, ub: jnp.ndarray,
                      iters: int = 12, zl0: jnp.ndarray | None = None,
                      zu0: jnp.ndarray | None = None, return_duals: bool = False):
    """Primal-dual interior point for box QPs, fixed `iters` Newton steps.

    KKT system with slacks sl = z - lb, su = ub - z and multipliers zl, zu:
        H z + g - zl + zu = 0,   sl.zl = mu,   su.zu = mu.
    Eliminating (zl, zu) gives a condensed Newton system
        (H + diag(zl/sl + zu/su)) dz = -r
    solved by batched Cholesky.  The barrier mu shrinks geometrically with a
    Mehrotra-flavoured adaptive target; steps are damped by
    fraction-to-the-boundary.  All shapes static -> vmap/pjit friendly.

    Warm start (zl0/zu0 given — the RTI cross-tick path, the role HPIPM's
    warm start plays inside acados SQP_RTI, `quad_opt.py:147-151`): in the
    RTI update U+ = U + z the next tick's QP is centred at z = 0 with the
    SAME u-box (shifted by z), so the previous tick's optimum maps to
    (z=0, zl, zu) exactly up to relinearization.  The primal starts at 0
    pushed WS_GAMMA into the box; duals are floored at WS_FLOOR.  With no
    zl0/zu0 the classic cold start (midpoint primal, unit duals) is used —
    bit-identical to the historical behaviour.
    """
    nz = H.shape[-1]
    dtype = H.dtype
    width = ub - lb

    if zl0 is None:
        # strictly interior cold start
        z = 0.5 * (lb + ub)
        zl = jnp.ones((nz,), dtype)
        zu = jnp.ones((nz,), dtype)
    else:
        z = jnp.clip(jnp.zeros((nz,), dtype), lb + WS_GAMMA * width,
                     ub - WS_GAMMA * width)
        zl = jnp.maximum(zl0, WS_FLOOR)
        zu = jnp.maximum(zu0, WS_FLOOR)
    sl = z - lb
    su = ub - z

    def body(carry, _):
        z, sl, su, zl, zu = carry
        duality_gap = (jnp.dot(sl, zl, precision=HP)
                       + jnp.dot(su, zu, precision=HP)) / (2 * nz)
        mu = 0.1 * duality_gap

        r = jnp.dot(H, z, precision=HP) + g - zl + zu
        # condensed Newton matrix
        d = zl / sl + zu / su
        M = H + jnp.diag(d)
        rhs = -r + (mu - sl * zl) / sl - (mu - su * zu) / su
        dz = _sym_solve(M, rhs)

        dzl = (mu - sl * zl - zl * dz) / sl
        dzu = (mu - su * zu + zu * dz) / su
        dsl = dz
        dsu = -dz

        # fraction-to-the-boundary step size (tau = 0.995)
        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
            return jnp.minimum(1.0, 0.995 * jnp.min(ratio))

        alpha = jnp.minimum(
            jnp.minimum(max_step(sl, dsl), max_step(su, dsu)),
            jnp.minimum(max_step(zl, dzl), max_step(zu, dzu)),
        )

        z = z + alpha * dz
        sl = z - lb
        su = ub - z
        # keep slacks strictly positive for numerical safety
        eps = jnp.asarray(1e-10, dtype) * jnp.maximum(width, 1.0)
        sl = jnp.maximum(sl, eps)
        su = jnp.maximum(su, eps)
        zl = jnp.maximum(zl + alpha * dzl, jnp.asarray(1e-12, dtype))
        zu = jnp.maximum(zu + alpha * dzu, jnp.asarray(1e-12, dtype))
        return (z, sl, su, zl, zu), None

    (z, sl, su, zl, zu), _ = jax.lax.scan(body, (z, sl, su, zl, zu), None, length=iters)
    zc = jnp.clip(z, lb, ub)
    if return_duals:
        return zc, zl, zu
    return zc


@partial(jax.jit, static_argnames=("iters",))
def solve_box_qp_projected_newton(H: jnp.ndarray, g: jnp.ndarray, lb: jnp.ndarray,
                                  ub: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Projected Newton (Bertsekas 1982) with a masked KKT solve.

    At each iteration the active set A = {i : (z_i at lb and grad_i > 0) or
    (z_i at ub and grad_i < 0)} is frozen; the free sub-Hessian system is
    solved by masking rows/cols of H to identity (static shapes), then the
    full step is projected onto the box.
    """
    nz = H.shape[-1]
    dtype = H.dtype
    eps = jnp.asarray(1e-9, dtype)
    I = jnp.eye(nz, dtype=dtype)

    z = jnp.clip(jnp.zeros_like(g), lb, ub)

    def body(z, _):
        grad = jnp.dot(H, z, precision=HP) + g
        at_lb = (z <= lb + eps) & (grad > 0)
        at_ub = (z >= ub - eps) & (grad < 0)
        active = at_lb | at_ub
        free = ~active
        fm = free.astype(dtype)
        # masked Hessian: free block of H, identity on active diag
        Hm = H * jnp.outer(fm, fm) + I * (1.0 - fm)
        rhs = -grad * fm
        dz = _sym_solve(Hm, rhs)
        z_new = jnp.clip(z + dz, lb, ub)
        return z_new, None

    z, _ = jax.lax.scan(body, z, None, length=iters)
    return z


def qp_kkt_residual(H, g, lb, ub, z):
    """Max KKT violation of a box-QP candidate (for tests / convergence
    telemetry): projected-gradient norm."""
    grad = jnp.dot(H, z, precision=HP) + g
    proj = jnp.clip(z - grad, lb, ub) - z
    return jnp.max(jnp.abs(proj))
