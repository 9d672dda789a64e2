"""Structure-of-arrays MPC dynamics: the linearization hot path, lane-major.

Same math as `make_mpc_dynamics` (`augmented.py` / `dynamics._f_core`,
reference `quad_opt.py:164-262`), but with the state laid out as (13, *M) —
component index leading, the (node, scenario) batch trailing — so every
operation in the dynamics AND in each of the 17 forward tangents through the
RK4 shooting map is one elementwise sweep over all scenarios, instead of
B*N tiny 13- or 17-wide problems.  On one H100 (400 W limit) the batched
linearization takes 8.0 ms this way at B=65536, N=10, against 16.5 ms for
vmapped jacfwd of the array-of-structures model, timed in one run (PERF.md).

Used by `SQPSolver.solve_batch` (`ops/lanes.linearize`) via the `.soa`
attribute that `make_mpc_dynamics` attaches; `tests/test_soa.py` pins it
against the jacfwd-of-AoS oracle.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from .augmented import FoldedDrag, drag_mean
from .params import QuadParams


def make_mpc_dynamics_soa(p: QuadParams) -> Callable:
    """Continuous-time MPC model in SoA layout.

    Returns f(x, u, aug) with x: (13, *M), u: (4, *M) for any trailing
    batch shape M, aug: None or a FoldedDrag whose leaves carry trailing
    axes that broadcast against M (X/w: (3, nb, *M), L/sigma_f: (3, *M)) or
    none (shared model).  Output: (13, *M).
    """
    # params are scalars / small vectors (the MPC model is the nominal quad).
    # Op order/association mirrors `_f_core` exactly so results match the
    # AoS path bit-for-bit even with f32 params under x64 tracing.
    J0, J1, J2 = p.J[0], p.J[1], p.J[2]
    a_payload_z = -(p.payload_mass / p.mass) * p.g[2]  # (`quad.py:353` quirk)

    def f(x: jnp.ndarray, u: jnp.ndarray, aug: Optional[FoldedDrag] = None) -> jnp.ndarray:
        qw, qx, qy, qz = x[3], x[4], x[5], x[6]
        vx, vy, vz = x[7], x[8], x[9]
        wx, wy, wz = x[10], x[11], x[12]

        def col(v):                                    # (4,) -> (4, 1, ...)
            return v.reshape(v.shape + (1,) * (u.ndim - 1))

        ft = u * col(p.rotor_functionality) * p.max_thrust  # (4, *M)
        thrust = jnp.sum(ft, axis=0)

        # attitude: q̇ = ½ S(w) q  (same closed form as `quaternion_derivative`)
        dqw = 0.5 * (-wx * qx - wy * qy - wz * qz)
        dqx = 0.5 * (wx * qw + wz * qy - wy * qz)
        dqy = 0.5 * (wy * qw - wz * qx + wx * qz)
        dqz = 0.5 * (wz * qw + wy * qx - wx * qy)

        # rotation-matrix entries, unnormalised quadratic form (`q_to_rot_mat`)
        r11 = 1 - 2 * (qy * qy + qz * qz)
        r12 = 2 * (qx * qy - qw * qz)
        r13 = 2 * (qx * qz + qw * qy)
        r21 = 2 * (qx * qy + qw * qz)
        r22 = 1 - 2 * (qx * qx + qz * qz)
        r23 = 2 * (qy * qz - qw * qx)
        r31 = 2 * (qx * qz - qw * qy)
        r32 = 2 * (qy * qz + qw * qx)
        r33 = 1 - 2 * (qx * qx + qy * qy)

        a_m = thrust / p.mass
        avx = r13 * a_m - p.g[0]
        avy = r23 * a_m - p.g[1]
        avz = r33 * a_m - p.g[2] + a_payload_z

        if aug is not None:
            # v_body = R(q)ᵀ v
            vbx = r11 * vx + r21 * vy + r31 * vz
            vby = r12 * vx + r22 * vy + r32 * vz
            vbz = r13 * vx + r23 * vy + r33 * vz
            vb = jnp.stack([vbx, vby, vbz], axis=0)    # (3, *M)
            X_b, w_b, L_b, sf_b = aug.X, aug.w, aug.L, aug.sigma_f
            if X_b.ndim == 2:                          # shared model, no M axes
                X_b, w_b = col(X_b), col(w_b)
                L_b, sf_b = col(L_b), col(sf_b)
            mean = drag_mean(vb, X_b, w_b, L_b, sf_b)  # (3, *M) body-frame drag
            # rotate the learned accel back to world: a_w = R(q) mean
            avx = avx + r11 * mean[0] + r12 * mean[1] + r13 * mean[2]
            avy = avy + r21 * mean[0] + r22 * mean[1] + r23 * mean[2]
            avz = avz + r31 * mean[0] + r32 * mean[1] + r33 * mean[2]

        tx = jnp.sum(ft * col(p.y_f), axis=0)
        ty = -jnp.sum(ft * col(p.x_f), axis=0)
        tz = jnp.sum(ft * col(p.z_l_tau), axis=0)
        dwx = (tx + (J1 - J2) * wy * wz) / J0
        dwy = (ty + (J2 - J0) * wz * wx) / J1
        dwz = (tz + (J0 - J1) * wx * wy) / J2

        return jnp.stack(
            [vx, vy, vz, dqw, dqx, dqy, dqz, avx, avy, avz, dwx, dwy, dwz], axis=0
        )

    return f
