"""Quaternion / rotation algebra as pure jnp functions.

Capability parity with the reference's dual numpy/CasADi helpers
(`/root/reference/src/utils/utils.py:286-457`) — here there is a single
implementation that works under jit / vmap / grad on any leading batch
dimensions (the reference needed twin numpy+CasADi code paths because CasADi
could not trace numpy; JAX tracing removes that duplication).

Quaternion convention: wxyz (scalar first), matching the reference.
All functions broadcast over arbitrary leading batch dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def q_to_rot_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix of a (possibly non-unit) quaternion.

    Matches the reference formula exactly (`utils/utils.py:326-339`): the
    matrix entries are the *unnormalised* quadratic form — the reference does
    NOT normalise, and neither do we (parity for non-unit quaternions matters
    because the plant integrator deliberately never renormalises,
    `quad.py:188`).

    q: (..., 4) wxyz.  Returns (..., 3, 3).
    """
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            jnp.stack([1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], axis=-1),
            jnp.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)], axis=-1),
            jnp.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)], axis=-1),
        ],
        axis=-2,
    )
    return r


def v_dot_q(v: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector v (..., 3) by quaternion q (..., 4).  (`utils.py:317-322`)"""
    return jnp.einsum("...ij,...j->...i", q_to_rot_mat(q), v,
                      precision=jax.lax.Precision.HIGHEST)


def quaternion_inverse(q: jnp.ndarray) -> jnp.ndarray:
    """Conjugate quaternion (inverse for unit quats).  (`utils.py:434-440`)"""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def q_dot_q(q: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product: rotate quaternion q by r.  (`utils.py:344-365`)"""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return jnp.stack(
        [
            rw * qw - rx * qx - ry * qy - rz * qz,
            rw * qx + rx * qw - ry * qz + rz * qy,
            rw * qy + rx * qz + ry * qw - rz * qx,
            rw * qz - rx * qy + ry * qx + rz * qw,
        ],
        axis=-1,
    )


def unit_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Normalise to unit modulus.  (`utils.py:301-314`)"""
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def skew_symmetric4(w: jnp.ndarray) -> jnp.ndarray:
    """4x4 'PAMPC' quaternion-rate matrix S(w) with q̇ = ½ S(w) q.

    (`utils.py:399-412`).  w: (..., 3) body rates -> (..., 4, 4).
    """
    z = jnp.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return jnp.stack(
        [
            jnp.stack([z, -wx, -wy, -wz], axis=-1),
            jnp.stack([wx, z, wz, -wy], axis=-1),
            jnp.stack([wy, -wz, z, wx], axis=-1),
            jnp.stack([wz, wy, -wx, z], axis=-1),
        ],
        axis=-2,
    )


def quaternion_derivative(q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """q̇ = ½ S(w) q, written closed-form (avoids materialising the 4x4)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return 0.5 * jnp.stack(
        [
            -wx * qx - wy * qy - wz * qz,
            wx * qw + wz * qy - wy * qz,
            wy * qw - wz * qx + wx * qz,
            wz * qw + wy * qx - wx * qy,
        ],
        axis=-1,
    )


def euler_to_quaternion(roll, pitch, yaw) -> jnp.ndarray:
    """rpy (radians) -> wxyz quaternion.  (`utils.py:286-292`)"""
    cr, sr = jnp.cos(roll / 2), jnp.sin(roll / 2)
    cp, sp = jnp.cos(pitch / 2), jnp.sin(pitch / 2)
    cy, sy = jnp.cos(yaw / 2), jnp.sin(yaw / 2)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def quaternion_to_euler(q: jnp.ndarray) -> jnp.ndarray:
    """wxyz quaternion -> (roll, pitch, yaw).  Parity with `utils.py:296-299`
    (which delegated to pyquaternion); implemented directly here."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # normalise defensively — Euler extraction assumes a unit quaternion
    n = jnp.sqrt(qw**2 + qx**2 + qy**2 + qz**2)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    roll = jnp.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx**2 + qy**2))
    pitch = jnp.arcsin(jnp.clip(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = jnp.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy**2 + qz**2))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def undo_quaternion_flip(q_past: jnp.ndarray, q_current: jnp.ndarray) -> jnp.ndarray:
    """Remove a sign flip in a quaternion series.  (`utils.py:386-397`)"""
    d_same = jnp.sum((q_past - q_current) ** 2, axis=-1, keepdims=True)
    d_flip = jnp.sum((q_past + q_current) ** 2, axis=-1, keepdims=True)
    return jnp.where(d_same > d_flip, -q_current, q_current)


def decompose_quaternion(q: jnp.ndarray):
    """Split q into xy-tilt and z-yaw rotations.  (`utils.py:415-431`)"""
    w, z = q[..., 0], q[..., 3]
    qz = jnp.stack([w, jnp.zeros_like(w), jnp.zeros_like(w), z], axis=-1)
    qz = unit_quat(qz)
    qxy = q_dot_q(q, quaternion_inverse(qz))
    return qxy, qz


def rotation_matrix_to_quat(rot: jnp.ndarray) -> jnp.ndarray:
    """3x3 rotation matrix -> wxyz quaternion.  Parity with `utils.py:367-376`
    (which delegated to pyquaternion); implemented here via the
    branch-free Shepperd-style construction: all four candidate squares are
    computed and the numerically dominant one selected with `where`, keeping
    the function jit/vmap friendly (no data-dependent branching)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidates, each valid where its pivot is the largest
    qw2 = jnp.maximum(1.0 + tr, 0.0)
    qx2 = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy2 = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz2 = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    def from_w():
        s = 2.0 * jnp.sqrt(qw2)
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                          (m10 - m01) / s], axis=-1)

    def from_x():
        s = 2.0 * jnp.sqrt(qx2)
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                          (m02 + m20) / s], axis=-1)

    def from_y():
        s = 2.0 * jnp.sqrt(qy2)
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                          (m12 + m21) / s], axis=-1)

    def from_z():
        s = 2.0 * jnp.sqrt(qz2)
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                          0.25 * s], axis=-1)

    cands = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    idx = jnp.argmax(cands, axis=-1)
    eps = jnp.asarray(1e-12, dtype=rot.dtype)
    # guard each candidate's divisor so the unselected branches stay finite
    qw2, qx2, qy2, qz2 = (jnp.maximum(c, eps) for c in (qw2, qx2, qy2, qz2))
    quats = jnp.stack([from_w(), from_x(), from_y(), from_z()], axis=-2)
    q = jnp.take_along_axis(quats, idx[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    return unit_quat(q)


def rotation_matrix_to_euler(r_mat: jnp.ndarray) -> jnp.ndarray:
    """3x3 rotation matrix -> (roll, pitch, yaw).  (`utils.py:443-457`)"""
    return quaternion_to_euler(rotation_matrix_to_quat(r_mat))
