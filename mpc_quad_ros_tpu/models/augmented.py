"""MPC model dynamics: nominal rigid body + learned drag augmentation.

The reference builds this symbolically in CasADi
(`/root/reference/src/quad_opt.py:164-262`): nominal f plus, when a GP/RGP is
attached, the per-axis GP mean evaluated at the body-frame velocity, rotated
to world and added to v̇ through the B_x selector.  Here the same model is a
plain traced function; the RGP "solver parameters" (`quad_opt.py:400-404`)
are just the `aug` pytree argument, so online updates never trigger a rebuild.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.rotations import quaternion_inverse, v_dot_q
from .dynamics import f_nominal
from .params import QuadParams
from .rgp import RGPState, rgp_predict_using_y
from .gp import GPState, gp_predict


class FoldedDrag(NamedTuple):
    """Solve-invariant form of the learned drag model.

    During one MPC solve the GP/RGP posterior is frozen, so the per-axis mean
    k(v, X) K_x⁻¹ mu_g collapses to k(v, X) · w with w := K_x⁻¹ mu_g folded
    once per solve — removing an (nb × nb) matmul from every RK4-stage
    evaluation AND from each of the 17 jacfwd tangents through it (the
    linearization hot path).  GPState already stores this form (`alpha`)."""

    X: jnp.ndarray        # (3, nb) basis/training inputs per axis
    w: jnp.ndarray        # (3, nb) folded weights per axis
    L: jnp.ndarray        # (3,) RBF lengthscale per axis
    sigma_f: jnp.ndarray  # (3,) RBF signal scale per axis


def _drag_kernel(vb, X_b, L_b, sf_b):
    diff = vb[:, None] - X_b
    k = sf_b[:, None] ** 2 * jnp.exp(-0.5 * diff**2 / (L_b[:, None] ** 2))
    return diff, k


@jax.custom_jvp
def drag_mean(vb, X_b, w_b, L_b, sf_b):
    """Per-axis folded drag mean sum_b k(vb_a, X_ab) w_ab in lane-major
    layout: vb (3, ...), X_b/w_b (3, nb, ...), L_b/sf_b (3, ...), where
    "..." is any trailing batch shape.

    Each axis's mean is a 1-D GP in vb[a] alone, so its Jacobian in vb is
    DIAGONAL.  The custom rule computes (mean, Jdiag) from the primal once
    and each tangent costs one multiply, where plain AD re-sweeps the
    (3, nb, ...) kernel products for every tangent — 17 of them per RK4
    linearization.  Only vb carries a tangent: the model is frozen during
    a solve."""
    _, k = _drag_kernel(vb, X_b, L_b, sf_b)
    return jnp.sum(k * w_b, axis=1)


@drag_mean.defjvp
def _drag_mean_jvp(primals, tangents):
    vb, X_b, w_b, L_b, sf_b = primals
    diff, k = _drag_kernel(vb, X_b, L_b, sf_b)
    kw = k * w_b
    jdiag = jnp.sum(kw * (-diff / (L_b[:, None] ** 2)), axis=1)
    return jnp.sum(kw, axis=1), jdiag * tangents[0]


def fold_drag(aug):
    """Fold an RGP/GP ensemble state into FoldedDrag (idempotent; None and
    already-folded pass through, unknown pytrees are returned unchanged).
    Supports extra leading batch dims on every leaf."""
    if aug is None or isinstance(aug, FoldedDrag):
        return aug
    if isinstance(aug, RGPState):
        w = jnp.einsum("...ij,...j->...i", aug.K_x_inv, aug.mu_g,
                       precision=jax.lax.Precision.HIGHEST)
        return FoldedDrag(X=aug.X, w=w, L=aug.theta[..., 0], sigma_f=aug.theta[..., 1])
    if isinstance(aug, GPState):
        return FoldedDrag(X=aug.X, w=aug.alpha, L=aug.theta[..., 0],
                          sigma_f=aug.theta[..., 1])
    return aug


def gp_mean_world(x: jnp.ndarray, aug) -> jnp.ndarray:
    """World-frame learned-drag acceleration at state x.

    aug: stacked (3, ...) RGPState, GPState or FoldedDrag.  Mirrors
    `quad_opt.py:211-243`: v_body = R(q)ᵀ v; per-axis mean at v_body[d];
    rotate the 3-vector of means back to world.
    """
    q = x[..., 3:7]
    v_body = v_dot_q(x[..., 7:10], quaternion_inverse(q))
    if isinstance(aug, FoldedDrag):
        # one fused broadcast over the 3 axes — no vmap, no matmul
        diff = v_body[..., :, None] - aug.X                       # (3, nb)
        k = aug.sigma_f[..., :, None] ** 2 * jnp.exp(
            -0.5 * diff**2 / (aug.L[..., :, None] ** 2)
        )
        mean = jnp.sum(k * aug.w, axis=-1)
    elif isinstance(aug, RGPState):
        mean = jax.vmap(lambda st, vb: rgp_predict_using_y(st, vb[None], st.mu_g)[0])(
            aug, v_body
        )
    elif isinstance(aug, GPState):
        mean = jax.vmap(lambda st, vb: gp_predict(st, vb[None])[0])(aug, v_body)
    else:
        raise TypeError(f"unsupported augmentation state: {type(aug)}")
    return v_dot_q(mean, q)


def make_mpc_dynamics(params: QuadParams) -> Callable:
    """Continuous-time MPC model f(x, u, aug) -> ẋ.

    aug is None (gp0 — nominal model), an RGPState stacked over 3 axes
    (gp2 — online recursive GP) or a GPState stacked over 3 axes (gp1 —
    pretrained batch GP).  The augmentation is evaluated *inside* every RK4
    stage of the shooting integrator, exactly like the reference's ERK over
    the corrected CasADi model.
    """

    def f(x, u, aug=None):
        dx = f_nominal(x, u, params)
        if aug is None:
            return dx
        a_world = gp_mean_world(x, aug)
        return dx.at[..., 7:10].add(a_world)

    # lane-major twin for the batched linearization hot path (see
    # `dynamics_soa.py`); consumed by SQPSolver.solve_batch when present
    from .dynamics_soa import make_mpc_dynamics_soa

    f.soa = make_mpc_dynamics_soa(params)
    return f
