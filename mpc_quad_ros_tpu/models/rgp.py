"""Recursive Gaussian Process (RGP) on fixed basis vectors — pure JAX.

Capability parity with the reference `RGP` class
(`/root/reference/src/gp/RGP.py:105-505`): RBF kernel, gain-matrix prediction,
Kalman-style recursive update of the basis-vector posterior (`regress`), and
the joint basis+hyperparameter update via the unscented transform (`learn`).

Design differences (TPU-first, not a port):

- State is an immutable NamedTuple of arrays — carried through `lax.scan`
  ticks and vmapped over (axis, episode) batch dims.  The reference's 3-axis
  `GPEnsemble` of Python objects becomes a leading dim of size 3.
- One implementation serves both the "numpy path" and the "CasADi symbolic
  path" of the reference: `rgp_predict_using_y` with a traced `y` is exactly
  what the reference built symbolically to inject learned drag means into the
  MPC (`RGP.py:235-300`, used by `quad_opt.py:211-256`).
- O(nb^2) per-tick math is expressed as einsums so thousands of episodes
  batch into a few large device operations.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RGPState(NamedTuple):
    """Posterior state of a 1-D-input, 1-D-output RGP with nb basis vectors.

    Ensemble/batching: add leading axes (e.g. (3, nb) for the per-body-axis
    ensemble, (B, 3, nb) for B episodes) and vmap the functions below.
    """

    X: jnp.ndarray        # (nb,) basis vector locations
    mu_g: jnp.ndarray     # (nb,) posterior mean at basis vectors
    C_g: jnp.ndarray      # (nb, nb) posterior covariance at basis vectors
    K_x_inv: jnp.ndarray  # (nb, nb) precomputed (K(X,X) + sigma_n^2 I)^-1
    theta: jnp.ndarray    # (3,) hyperparameters [L, sigma_f, sigma_n]


def rbf(x1: jnp.ndarray, x2: jnp.ndarray, L, sigma_f) -> jnp.ndarray:
    """RBF kernel matrix k(x1[i], x2[j]) = sigma_f^2 exp(-(x1-x2)^2 / (2 L^2)).

    (`RGP.py:24-99` — the reference fills this with a double Python loop; here
    it is one broadcasted expression.)
    x1: (..., n), x2: (..., m) -> (..., n, m)
    """
    diff = x1[..., :, None] - x2[..., None, :]
    return sigma_f**2 * jnp.exp(-0.5 * diff**2 / (L * L))


def rgp_kernel_matrix(state: RGPState, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    L, sigma_f = state.theta[0], state.theta[1]
    return rbf(x1, x2, L, sigma_f)


def rgp_init(X: jnp.ndarray, y: jnp.ndarray | None = None, C: jnp.ndarray | None = None,
             theta=(1.0, 0.1, 0.1)) -> RGPState:
    """Initialise from basis vectors (`RGP.py:106-157`).

    The prior mean is y (zeros when learning from scratch, the gp2 mode of
    `GPEnsemble.fromemptybasisvectors`, `GPE.py:115-127`); the prior
    covariance is K(X,X) + sigma_n^2 I unless C is given.
    """
    X = jnp.asarray(X)
    theta = jnp.asarray(theta, dtype=X.dtype)
    y = jnp.zeros_like(X) if y is None else jnp.asarray(y, dtype=X.dtype)
    L, sigma_f, sigma_n = theta[0], theta[1], theta[2]
    K_x = rbf(X, X, L, sigma_f) + sigma_n**2 * jnp.eye(X.shape[-1], dtype=X.dtype)
    C_g = K_x if C is None else jnp.asarray(C, dtype=X.dtype)
    K_x_inv = jnp.linalg.inv(K_x)
    return RGPState(X=X, mu_g=y, C_g=C_g, K_x_inv=K_x_inv, theta=theta)


def rgp_gain(state: RGPState, x_star: jnp.ndarray) -> jnp.ndarray:
    """Gain matrix J_t = K(x*, X) K_x^-1  (`RGP.py:199`)."""
    K_star = rgp_kernel_matrix(state, x_star, state.X)
    return K_star @ state.K_x_inv


def rgp_predict(state: RGPState, x_star: jnp.ndarray, with_cov: bool = False):
    """Posterior mean (and covariance) at x_star (`RGP.py:168-229`).

    x_star: (m,).  Returns mu (m,) or (mu, C_p, J_t) when with_cov.
    """
    Jt = rgp_gain(state, x_star)
    mu = Jt @ state.mu_g
    if not with_cov:
        return mu
    K_ss = rgp_kernel_matrix(state, x_star, x_star)
    B = K_ss - Jt @ rgp_kernel_matrix(state, state.X, x_star)
    C_p = B + Jt @ state.C_g @ Jt.T
    return mu, C_p, Jt


def rgp_predict_using_y(state: RGPState, x_star: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Posterior mean at x_star given an external basis-vector response y.

    This is the reference's *symbolic* MPC injection path
    (`RGP.py:235-300`): the MPC dynamics evaluate J_t(x*) · y where y is the
    learned mean passed as a solver parameter.  Here y is just a traced array.
    """
    return rgp_gain(state, x_star) @ y


def rgp_regress(state: RGPState, x_t: jnp.ndarray, y_t: jnp.ndarray,
                symmetrize: bool = True) -> RGPState:
    """Kalman-style recursive update with new data (x_t, y_t) (`RGP.py:303-330`).

    x_t, y_t: (k,) new points (k=1 in the control loop).
    Returns the updated state (X, K_x_inv, theta unchanged).

    `symmetrize` re-symmetrises C_g after the update — a no-op in exact
    arithmetic, but it keeps the covariance PSD-ish over 1e5+ sequential f32
    updates (SURVEY §7 "hard parts").
    """
    sigma_n = state.theta[2]
    k = x_t.shape[-1]
    if k == 1:
        # Fully elementwise k=1 fast path (the control-loop case).  The
        # generic path's tiny matmuls — and especially the (1,1)
        # jnp.linalg.solve — become batched dot_generals / LU custom calls
        # under vmap over (B, 3) episodes, each padded far beyond its ~nb^2
        # FLOPs of actual math.  Broadcast-multiply-reduce keeps the update
        # one elementwise fusion, with no matrix product.  Same formulas
        # (`RGP.py:303-330`), reassociation-level numerics only (pinned vs
        # the numpy oracles in tests/test_rgp.py).
        L_, sf = state.theta[0], state.theta[1]
        x1 = x_t[0]
        kx = sf**2 * jnp.exp(-0.5 * (x1 - state.X) ** 2 / (L_ * L_))  # (nb,)
        Jt1 = jnp.sum(kx[:, None] * state.K_x_inv, axis=0)            # (nb,)
        mu_p1 = jnp.sum(Jt1 * state.mu_g)
        B1 = sf**2 - jnp.sum(Jt1 * kx)             # k(x*,x*) - Jt K(X, x*)
        CJ = jnp.sum(state.C_g * Jt1[None, :], axis=1)                # (nb,)
        C_p1 = B1 + jnp.sum(Jt1 * CJ)
        G1 = CJ / (C_p1 + sigma_n**2)                                 # (nb,)
        mu_new = state.mu_g + G1 * (y_t[0] - mu_p1)
        JC = jnp.sum(Jt1[:, None] * state.C_g, axis=0)                # (nb,)
        C_new = state.C_g - G1[:, None] * JC[None, :]
    else:
        mu_p, C_p, Jt = rgp_predict(state, x_t, with_cov=True)
        S = C_p + sigma_n**2 * jnp.eye(k, dtype=x_t.dtype)
        # Kalman gain G̃ = C_g Jtᵀ S^-1  (`RGP.py:324-326`)
        G = jnp.linalg.solve(S, (state.C_g @ Jt.T).T).T
        mu_new = state.mu_g + G @ (y_t - mu_p)
        C_new = state.C_g - G @ Jt @ state.C_g
    if symmetrize:
        C_new = 0.5 * (C_new + C_new.T)
    return state._replace(mu_g=mu_new, C_g=C_new)


def _sqrtm_psd(C: jnp.ndarray) -> jnp.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition (replaces
    scipy.linalg.sqrtm used at `RGP.py:499-500`)."""
    vals, vecs = jnp.linalg.eigh(C)
    vals = jnp.clip(vals, 0.0, None)
    return (vecs * jnp.sqrt(vals)) @ vecs.T


class RGPLearnState(NamedTuple):
    """Extended state for the RGP* joint basis+hyperparameter learner
    (`RGP.py:146-153`): hyperparameter posterior and cross-covariance."""

    base: RGPState
    mu_eta: jnp.ndarray    # (3,) hyperparameter mean [L, sigma_f, sigma_n]
    C_eta: jnp.ndarray     # (3, 3)
    C_g_eta: jnp.ndarray   # (nb, 3)


def rgp_learn_init(state: RGPState) -> RGPLearnState:
    nb = state.X.shape[-1]
    return RGPLearnState(
        base=state,
        mu_eta=state.theta,
        C_eta=jnp.eye(3, dtype=state.X.dtype),
        C_g_eta=jnp.zeros((nb, 3), dtype=state.X.dtype),
    )


def rgp_learn(ls: RGPLearnState, x_t: jnp.ndarray, y_t: jnp.ndarray) -> RGPLearnState:
    """Joint basis + hyperparameter update via the unscented transform.

    Faithful re-derivation of `RGP.py:332-480` (single scalar observation,
    as in the reference: n_g_t == 1).  Not on the control-loop hot path —
    the reference never calls `learn` from the controller either (SURVEY §2)
    — but provided for full capability parity with `rgp_train`-style offline
    streams.
    """
    st = ls.base
    n_g = st.mu_g.shape[-1]
    n_eta = ls.mu_eta.shape[-1]
    dtype = st.X.dtype

    L, sigma_f, sigma_n = ls.mu_eta[0], ls.mu_eta[1], ls.mu_eta[2]
    Jt = rbf(x_t, st.X, L, sigma_f) @ st.K_x_inv            # (1, n_g)
    B = rbf(x_t, x_t, L, sigma_f) - Jt @ rbf(st.X, x_t, L, sigma_f)  # (1,1)
    St = jnp.linalg.solve(ls.C_eta.T, ls.C_g_eta.T).T       # C_g_eta C_eta^-1, (n_g, n_eta)

    n_p = n_g + n_eta + 1
    At = jnp.zeros((n_p, n_g + n_eta), dtype=dtype)
    At = At.at[:n_g, :n_g].set(jnp.eye(n_g, dtype=dtype))
    At = At.at[n_g:n_g + n_eta, n_g:].set(jnp.eye(n_eta, dtype=dtype))
    At = At.at[n_g + n_eta:, :n_g].set(Jt)

    C_w = jnp.zeros((n_p, n_p), dtype=dtype).at[-1, -1].set(B[0, 0])

    # --- unscented transform over eta (`RGP.py:483-505`) ---
    w0 = 0.5
    n = n_eta
    sq = _sqrtm_psd(n / (1.0 - w0) * ls.C_eta)
    eta_pts = jnp.concatenate(
        [ls.mu_eta[None, :], ls.mu_eta[None, :] + sq.T, ls.mu_eta[None, :] - sq.T], axis=0
    )  # (2n+1, n_eta); sq.T rows are columns of the sqrt
    w = jnp.concatenate([jnp.array([w0], dtype=dtype), jnp.full((2 * n,), (1 - w0) / (2 * n), dtype=dtype)])

    def point_moments(eta_i):
        mu_i = At @ jnp.concatenate([st.mu_g + St @ (eta_i - ls.mu_eta), eta_i])
        tmp = jnp.zeros((n_g + n_eta, n_g + n_eta), dtype=dtype)
        tmp = tmp.at[:n_g, :n_g].set(st.C_g - St @ ls.C_g_eta.T)
        C_i = At @ tmp @ At.T + C_w
        return mu_i, C_i

    mu_i, C_i = jax.vmap(point_moments)(eta_pts)
    # cumulative combination exactly as the reference loop (`RGP.py:401-404`):
    # the running mean is used inside each outer-product term, so this is a
    # sequential recurrence, reproduced with a scan.
    def comb(carry, inp):
        mu_acc, C_acc = carry
        wi, mui, Ci = inp
        mu_acc = mu_acc + wi * mui
        C_acc = C_acc + wi * (jnp.outer(mui - mu_acc, mui - mu_acc) + Ci)
        return (mu_acc, C_acc), None

    (mu_p, C_p), _ = jax.lax.scan(
        comb, (jnp.zeros((n_p,), dtype=dtype), jnp.zeros((n_p, n_p), dtype=dtype)), (w, mu_i, C_i)
    )

    # --- update step (`RGP.py:407-457`) ---
    s = n_g + n_eta - 1  # index of sigma_n: last of eta
    mu_o, C_o = mu_p[s:], C_p[s:, s:]
    mu_u, C_u_prev = mu_p[:s], C_p[:s, :s]
    C_ou = C_p[s:, :s]

    mu_y = mu_o[1:]
    C_y = C_o[1:, 1:] + C_o[0, 0] + mu_o[0] ** 2
    C_o_y = C_o[:, 1:]
    Gt = jnp.linalg.solve(C_y.T, C_o_y.T).T
    mu_e = mu_o + Gt @ (y_t - mu_y)
    C_e = C_o - Gt @ C_y @ Gt.T

    Lt = jnp.linalg.solve(C_o.T, C_ou).T
    mu_u_new = mu_u + Lt @ (mu_e - mu_o)
    C_u_new = C_u_prev + Lt @ (C_e - C_o) @ Lt.T

    h = jnp.zeros_like(mu_e).at[0].set(1.0)
    mu_z = jnp.concatenate([mu_u_new, (h @ mu_e)[None]])
    top = jnp.concatenate([C_u_new, (Lt @ C_e @ h)[:, None]], axis=1)
    bot = jnp.concatenate([(h @ C_e @ Lt.T)[None, :], (h @ C_e @ h)[None, None]], axis=1)
    C_z = jnp.concatenate([top, bot], axis=0)

    mu_g_new = mu_z[:n_g]
    C_g_new = C_z[:n_g, :n_g]
    mu_eta_new = mu_z[n_g:]
    C_eta_new = C_z[n_g:, n_g:]
    # NOTE: the reference never updates the g/eta cross-covariance after a
    # learn step (`RGP.py:460-464` writes mu/C of g and eta only) — keep it.
    C_g_eta_new = ls.C_g_eta

    # the reference overwrites the exp() transform with the raw values
    # (`RGP.py:468-474`) — final semantics: theta = mu_eta as-is.
    L_new, sf_new, sn_new = mu_eta_new[0], mu_eta_new[1], mu_eta_new[2]
    K_x = rbf(st.X, st.X, L_new, sf_new) + sn_new**2 * jnp.eye(n_g, dtype=dtype)
    base = RGPState(
        X=st.X,
        mu_g=mu_g_new,
        C_g=C_g_new,
        K_x_inv=jnp.linalg.inv(K_x),
        theta=jnp.stack([L_new, sf_new, sn_new]),
    )
    return RGPLearnState(base=base, mu_eta=mu_eta_new, C_eta=C_eta_new, C_g_eta=C_g_eta_new)


# ---------------------------------------------------------------------------
# Ensemble / batched forms: the reference's 3-axis GPEnsemble (`GPE.py`)
# becomes vmapped single-GP functions over a leading axis.
# ---------------------------------------------------------------------------

def ensemble_init(x_min_max, n_basis: int, theta=(1.0, 0.1, 0.1), dtype=jnp.float32) -> RGPState:
    """3-axis RGP ensemble from per-axis (min, max) ranges
    (`GPEnsemble.fromrange`, `GPE.py:128-150`).  Returns an RGPState with
    leading axis 3."""
    X = jnp.stack(
        [jnp.linspace(lo, hi, n_basis, dtype=dtype) for (lo, hi) in x_min_max], axis=0
    )
    return jax.vmap(lambda Xd: rgp_init(Xd, theta=jnp.asarray(theta, dtype=dtype)))(X)


ensemble_predict = jax.vmap(rgp_predict)            # (3,nb) state, (3,m) query
ensemble_predict_using_y = jax.vmap(rgp_predict_using_y)
ensemble_regress = jax.vmap(rgp_regress)            # (3,k) new data
