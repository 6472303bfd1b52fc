"""SE(3) poses and camera-projection helpers.

Equivalent of the reference's ``lvt_pose`` / ``lvt_pose_utils``
(lvt/src/lvt_pose.h:51-98, lvt/src/lvt_pose.cpp:28-51). A pose is a small
pytree of ``(position[3], quaternion[4])`` expressing the *camera-in-world*
transform, exactly like the reference; all helpers are pure jnp and vmappable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lvt_tpu.geometry import quaternion as quat

# Precision of every f32 contraction in geometry and the solvers: without
# it XLA may run f32 products in TF32 on GPUs (about three decimal digits),
# which moves poses, normal equations and triangulated depths.
HIGHEST = jax.lax.Precision.HIGHEST


class Pose(NamedTuple):
    """Camera pose in world frame: x_world = R(q) @ x_cam + t."""

    t: jnp.ndarray  # [..., 3] position
    q: jnp.ndarray  # [..., 4] orientation (w, x, y, z), unit

    @staticmethod
    def identity(dtype=jnp.float32) -> "Pose":
        return Pose(jnp.zeros(3, dtype), quat.identity(dtype))

    def rotation_matrix(self) -> jnp.ndarray:
        return quat.to_matrix(self.q)

    def matrix34(self) -> jnp.ndarray:
        """Camera-to-world [R | t] (3x4)."""
        return jnp.concatenate(
            [self.rotation_matrix(), self.t[..., :, None]], axis=-1
        )

    def matrix44(self) -> jnp.ndarray:
        m34 = self.matrix34()
        bottom = jnp.zeros_like(m34[..., :1, :]).at[..., 0, 3].set(1.0)
        return jnp.concatenate([m34, bottom], axis=-2)

    @staticmethod
    def from_matrix44(m: jnp.ndarray) -> "Pose":
        return Pose(m[..., :3, 3], quat.from_matrix(m[..., :3, :3]))

    def compose(self, other: "Pose") -> "Pose":
        """Composition self * other (apply other first, then self)."""
        return Pose(
            quat.rotate(self.q, other.t) + self.t,
            quat.normalize(quat.multiply(self.q, other.q)),
        )

    def inverse(self) -> "Pose":
        qi = quat.inverse(self.q)
        return Pose(-quat.rotate(qi, self.t), qi)


def right_camera_pose(left: Pose, baseline) -> Pose:
    """Right stereo camera: same orientation, translated by baseline along
    the left camera's x axis (reference: lvt_pose.cpp:28-34)."""
    offset = jnp.stack(
        [jnp.asarray(baseline, left.t.dtype), jnp.zeros((), left.t.dtype), jnp.zeros((), left.t.dtype)]
    )
    return Pose(quat.rotate(left.q, offset) + left.t, left.q)


def world_to_camera(pose: Pose) -> jnp.ndarray:
    """World->camera transform [R^T | -R^T t] (3x4)
    (reference: lvt_pose.cpp:36-43)."""
    r_wc = jnp.swapaxes(quat.to_matrix(pose.q), -1, -2)
    t_wc = -jnp.einsum("...ij,...j->...i", r_wc, pose.t, precision=HIGHEST)
    return jnp.concatenate([r_wc, t_wc[..., :, None]], axis=-1)


def transform_points(m34: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply a [3x4] affine transform to points [..., 3]."""
    return (jnp.einsum("ij,...j->...i", m34[..., :3], pts, precision=HIGHEST)
            + m34[..., 3])


def project_points(
    pts_cam: jnp.ndarray, fx, fy, cx, cy, eps: float = 1e-12
) -> jnp.ndarray:
    """Pinhole projection of camera-frame points [..., 3] -> pixels [..., 2]."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def visibility_mask(
    pts_cam: jnp.ndarray,
    uv: jnp.ndarray,
    near: float,
    far: float,
    min_x: float,
    max_x: float,
    min_y: float,
    max_y: float,
) -> jnp.ndarray:
    """Frustum + image-bounds check, the vectorized ``is_point_visible``
    (reference: lvt_local_map.cpp:62-82)."""
    z = pts_cam[..., 2]
    ok_z = (z >= near) & (z <= far)
    u, v = uv[..., 0], uv[..., 1]
    ok_uv = (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)
    return ok_z & ok_uv
