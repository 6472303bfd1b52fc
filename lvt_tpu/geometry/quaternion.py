"""Unit-quaternion operations as pure jnp functions (vmappable).

Replacement for the Eigen quaternion usage throughout the
reference (lvt/src/lvt_pose.h:34-98, lvt/src/lvt_motion_model.cpp:42-65).

Convention: a quaternion is an array ``[..., 4]`` stored as ``(w, x, y, z)``
with Hamilton product; ``rotate(q, v) == R(q) @ v``.
"""

from __future__ import annotations

import jax.numpy as jnp


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def inverse(q: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a unit quaternion (== conjugate)."""
    return conjugate(q)


def multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a*b (rotation composition: first b then a)."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by unit quaternion(s) q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] of a unit quaternion."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion from a rotation matrix.

    Branch-free Shepperd-style extraction: computes all four candidate
    quaternions and selects the numerically best one with `where` (jit- and
    vmap-friendly, unlike the usual if/elif ladder).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidates, each scaled by 4*component^2 (always >= 0 for the max)
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(cand), 4(wxyz)]
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)
    q = q[..., 0, :]
    q = normalize(q)
    # canonical sign: w >= 0
    return jnp.where(q[..., :1] < 0, -q, q)


def slerp(a: jnp.ndarray, t, b: jnp.ndarray) -> jnp.ndarray:
    """Spherical interpolation from a (t=0) to b (t=1), shortest path.

    Matches Eigen's ``a.slerp(t, b)`` semantics (used by the reference's
    motion model, lvt/src/lvt_motion_model.cpp:49-52): takes the short way
    around by flipping the sign of b when dot < 0, and falls back to nlerp
    when the quaternions are nearly parallel.
    """
    dot = jnp.sum(a * b, axis=-1, keepdims=True)
    b = jnp.where(dot < 0, -b, b)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    eps = jnp.asarray(1e-6, a.dtype)
    near = sin_theta < eps
    # slerp weights (guard the division when near-parallel)
    safe_sin = jnp.where(near, jnp.ones_like(sin_theta), sin_theta)
    wa = jnp.where(near, 1.0 - t, jnp.sin((1.0 - t) * theta) / safe_sin)
    wb = jnp.where(near, t, jnp.sin(t * theta) / safe_sin)
    return normalize(wa * a + wb * b)


def angle_between(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle (radians) between two unit quaternions."""
    dot = jnp.abs(jnp.sum(a * b, axis=-1))
    return 2.0 * jnp.arccos(jnp.clip(dot, -1.0, 1.0))
