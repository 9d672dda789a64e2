"""Lanes-last batch kernels of `SQPSolver.solve_batch`: the scenario batch B
is the trailing axis of every array, so each operation is one elementwise
sweep over all scenarios instead of B tiny (13- or 40-wide) problems.

- `linearize`: RK4 shooting step + its 17 forward tangents for every
  (stage, scenario) column of the SoA model.
- `box_qp_pdip`: the box-QP interior point of `ops/qp.solve_box_qp_pdip`
  (same start, barrier schedule, step rule and iteration count), with its
  Cholesky and triangular solves unrolled over the tiny nz dimension.

Both are plain jnp that XLA compiles; neither issues a matrix product, so
there is nothing for TF32 to round.  The per-scenario `SQPSolver.solve`
(`ops/qp.py`) is their numerical oracle in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.augmented import FoldedDrag
from .qp import WS_FLOOR, WS_GAMMA

NX, NT = 13, 17
PANEL = 8            # Cholesky columns factored before each trailing update


def linearize(f_soa, X, U, dt, aug=None):
    """X: (N+1, 13, B), U: (N, 4, B); aug: FoldedDrag with per-scenario
    leaves (3, nb, B) / (3, B), or None.  Returns J (17, 13, N, B) — J[j, :, k]
    is column j of [A_k | B_k] — and the defects r (N, 13, B)."""
    x = jnp.moveaxis(X[:-1], 1, 0)                     # (13, N, B)
    u = jnp.moveaxis(U, 1, 0)                          # (4, N, B)
    if aug is not None:                                # broadcast over stages
        aug = FoldedDrag(X=aug.X[:, :, None], w=aug.w[:, :, None],
                         L=aug.L[:, None], sigma_f=aug.sigma_f[:, None])

    def step(x, u):
        k1 = f_soa(x, u, aug)
        k2 = f_soa(x + dt / 2 * k1, u, aug)
        k3 = f_soa(x + dt / 2 * k2, u, aug)
        k4 = f_soa(x + dt * k3, u, aug)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    xp = step(x, u)
    basis = jnp.eye(NT, dtype=X.dtype)

    def push(e):
        tx = jnp.broadcast_to(e[:NX, None, None], x.shape)
        tu = jnp.broadcast_to(e[NX:, None, None], u.shape)
        return jax.jvp(step, (x, u), (tx, tu))[1]

    J = jax.vmap(push)(basis)                          # (17, 13, N, B)
    return J, jnp.moveaxis(xp, 1, 0) - X[1:]


def _cholesky(M):
    """Lower Cholesky factor of each M[:, :, b] as a list of columns: column
    j is (nz - j0, B) with j0 the first row of its panel, zero above the
    diagonal.  Panel right-looking: the trailing block R shrinks in both
    dimensions after each panel, so its rank-1 updates touch live rows only.
    Returns (panels [(c0, width, columns)], 1/diag per column)."""
    nz = M.shape[0]
    panels, dinvs = [], []
    R = M
    for c0 in range(0, nz, PANEL):
        pw = min(PANEL, nz - c0)
        rows = jnp.arange(nz - c0)[:, None]
        cols = []
        for j in range(pw):
            a = R[:, j]
            for k in range(j):
                a = a - cols[k] * cols[k][j][None, :]
            dinv = jax.lax.rsqrt(a[j])
            cols.append(jnp.where(rows >= j, a * dinv[None, :], 0.0))
            dinvs.append(dinv)
        panels.append((c0, pw, cols))
        if c0 + pw < nz:
            R = R[pw:, pw:]
            for c in cols:
                t = c[pw:]
                R = R - t[:, None, :] * t[None, :, :]
    return panels, dinvs


def _cho_solve(panels, dinvs, rhs):
    """Solve L Lᵀ x = rhs (nz, B) with the factor of `_cholesky`."""
    ys, res = [], rhs
    for c0, pw, cols in panels:                        # L y = rhs
        for j in range(pw):
            y = res[j] * dinvs[c0 + j]
            ys.append(y)
            res = res - cols[j] * y[None, :]
        res = res[pw:]
    tail = None                                        # Lᵀ x = y
    for c0, pw, cols in reversed(panels):
        xs = [None] * pw
        for j in reversed(range(pw)):
            dot = (jnp.zeros_like(ys[0]) if tail is None
                   else jnp.sum(cols[j][pw:] * tail, axis=0))
            for k in range(j + 1, pw):
                dot = dot + cols[j][k] * xs[k]
            xs[j] = (ys[c0 + j] - dot) * dinvs[c0 + j]
        blk = jnp.stack(xs, axis=0)
        tail = blk if tail is None else jnp.concatenate([blk, tail], axis=0)
    return tail


def box_qp_pdip(H, g, lb, ub, zl0=None, zu0=None, *, iters: int):
    """`ops/qp.solve_box_qp_pdip` for B problems at once, lanes-last:
    H (nz, nz, B) symmetric, vectors (nz, B).  zl0/zu0 warm-start the duals
    (the primal then starts at 0 pushed WS_GAMMA into the box).  Returns
    (z, zl, zu)."""
    nz = H.shape[0]
    dtype = H.dtype
    eye = (jnp.arange(nz)[:, None] == jnp.arange(nz)[None, :])[..., None].astype(dtype)
    width = ub - lb
    if zl0 is None:
        z = 0.5 * (lb + ub)
        zl = jnp.ones_like(z)
        zu = jnp.ones_like(z)
    else:
        z = jnp.clip(jnp.zeros_like(g), lb + WS_GAMMA * width, ub - WS_GAMMA * width)
        zl = jnp.maximum(zl0, WS_FLOOR)
        zu = jnp.maximum(zu0, WS_FLOOR)
    sl = z - lb
    su = ub - z
    eps = 1e-10 * jnp.maximum(width, 1.0)

    def max_step(v, dv):
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(ratio, axis=0))

    def body(_, carry):
        z, sl, su, zl, zu = carry
        mu = 0.1 * (jnp.sum(sl * zl, axis=0) + jnp.sum(su * zu, axis=0)) / (2 * nz)
        r = jnp.sum(H * z[None, :, :], axis=1) + g - zl + zu
        d = zl / sl + zu / su
        rhs = -r + (mu - sl * zl) / sl - (mu - su * zu) / su
        dz = _cho_solve(*_cholesky(H + eye * d[None, :, :]), rhs)
        dzl = (mu - sl * zl - zl * dz) / sl
        dzu = (mu - su * zu + zu * dz) / su
        alpha = jnp.minimum(jnp.minimum(max_step(sl, dz), max_step(su, -dz)),
                            jnp.minimum(max_step(zl, dzl), max_step(zu, dzu)))
        z = z + alpha * dz
        sl = jnp.maximum(z - lb, eps)
        su = jnp.maximum(ub - z, eps)
        zl = jnp.maximum(zl + alpha * dzl, jnp.asarray(1e-12, dtype))
        zu = jnp.maximum(zu + alpha * dzu, jnp.asarray(1e-12, dtype))
        return z, sl, su, zl, zu

    z, sl, su, zl, zu = jax.lax.fori_loop(0, iters, body, (z, sl, su, zl, zu))
    return jnp.clip(z, lb, ub), zl, zu
