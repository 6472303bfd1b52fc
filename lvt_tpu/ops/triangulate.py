"""Batched stereo triangulation and RGB-D backprojection.

Replacement for the reference's per-pair Eigen 4x3 Jacobi-SVD
linear-LS triangulation (lvt/src/lvt_local_map.cpp:258-329) and RGB-D depth
backprojection (:231-256).

Design notes (diverging from the reference where batched execution
demands):

* The reference solves the algebraic linear-LS system in *world* coordinates.
  A rigid change of coordinates transforms the system as A' = A*T, so the
  minimizer is the same point expressed in the new frame — we therefore
  triangulate in the *left camera* frame, where the matrices are tiny and
  well-conditioned in float32 (world coordinates can be hundreds of meters
  from the origin late in a trajectory), then map to world with the
  camera-to-world transform. For a rectified pair the two projections are
  [I|0] and [I|(-b,0,0)].

* The 4x3 SVD becomes closed-form 3x3 normal equations solved in batch —
  no per-point SVD, everything vmappable/fusable.

* Visibility + left/right reprojection chi-square gating (<= 5.991) exactly
  as the reference, expressed as masks on the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lvt_tpu.geometry import se3
from lvt_tpu.geometry.se3 import HIGHEST


class TriangulationResult(NamedTuple):
    points_cam: jnp.ndarray   # [N, 3] in left-camera frame
    points_world: jnp.ndarray  # [N, 3]
    valid: jnp.ndarray        # [N] bool (input validity x gates)


def _solve33(m: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Batched 3x3 solve via adjugate (closed form, no LAPACK)."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], -1),
            jnp.stack([c10, c11, c12], -1),
            jnp.stack([c20, c21, c22], -1),
        ],
        axis=-2,
    )
    return (jnp.einsum("...ij,...j->...i", adj, b, precision=HIGHEST)
            * inv_det[..., None])


def triangulate_stereo(
    uv_left: jnp.ndarray,    # [N, 2] left pixel coords
    uv_right: jnp.ndarray,   # [N, 2] right pixel coords
    pair_valid: jnp.ndarray,  # [N] bool
    pose,                    # left camera pose (se3.Pose), camera-in-world
    *,
    fx, fy, cx, cy, baseline,
    near, far, min_x, max_x, min_y, max_y,
    reprojection_th2,
) -> TriangulationResult:
    """Linear-LS two-view triangulation with the reference's gating."""
    dtype = uv_left.dtype
    x1 = (uv_left[:, 0] - cx) / fx
    y1 = (uv_left[:, 1] - cy) / fy
    x2 = (uv_right[:, 0] - cx) / fx
    y2 = (uv_right[:, 1] - cy) / fy

    # Projections in the left-camera frame: P_L = [I | 0], P_R = [I | t_r]
    # with t_r = (-baseline, 0, 0) (right camera sits +baseline along x, so
    # world->right-camera translation is -baseline).
    b = jnp.asarray(baseline, dtype)
    # Rows of A (in camera frame):
    #   x1 * P_L[2] - P_L[0] = [-1, 0, x1 | 0]
    #   y1 * P_L[2] - P_L[1] = [0, -1, y1 | 0]
    #   x2 * P_R[2] - P_R[0] = [-1, 0, x2 | b]
    #   y2 * P_R[2] - P_R[1] = [0, -1, y2 | 0]
    n = uv_left.shape[0]
    zeros = jnp.zeros((n,), dtype)
    ones = jnp.ones((n,), dtype)
    a3 = jnp.stack(
        [
            jnp.stack([-ones, zeros, x1], -1),
            jnp.stack([zeros, -ones, y1], -1),
            jnp.stack([-ones, zeros, x2], -1),
            jnp.stack([zeros, -ones, y2], -1),
        ],
        axis=-2,
    )  # [N, 4, 3]
    a4 = jnp.stack([zeros, zeros, b * ones, zeros], axis=-1)  # [N, 4]

    # min ||a3 X + a4||  ->  (a3^T a3) X = -a3^T a4
    m33 = jnp.einsum("nij,nik->njk", a3, a3, precision=HIGHEST)
    rhs = -jnp.einsum("nij,ni->nj", a3, a4, precision=HIGHEST)
    pts_cam = _solve33(m33, rhs)  # [N, 3] left-camera frame

    finite = jnp.all(jnp.isfinite(pts_cam), axis=-1)

    # gating: visibility in both cameras + reprojection chi2
    uv_l = se3.project_points(pts_cam, fx, fy, cx, cy)
    vis_l = se3.visibility_mask(pts_cam, uv_l, near, far, min_x, max_x, min_y, max_y)
    pts_cam_r = pts_cam - jnp.stack([b, jnp.zeros_like(b), jnp.zeros_like(b)])
    uv_r = se3.project_points(pts_cam_r, fx, fy, cx, cy)
    vis_r = se3.visibility_mask(pts_cam_r, uv_r, near, far, min_x, max_x, min_y, max_y)

    err_l = jnp.sum((uv_l - uv_left) ** 2, axis=-1)
    err_r = jnp.sum((uv_r - uv_right) ** 2, axis=-1)
    ok = (
        pair_valid
        & finite
        & vis_l
        & vis_r
        & (err_l <= reprojection_th2)
        & (err_r <= reprojection_th2)
    )

    pts_world = se3.transform_points(pose.matrix34(), pts_cam)
    return TriangulationResult(pts_cam, pts_world, ok)


def backproject_rgbd(
    uv: jnp.ndarray,      # [N, 2] pixel coords
    depth: jnp.ndarray,   # [N] metric depth
    valid: jnp.ndarray,   # [N] bool
    pose,                 # camera pose (se3.Pose)
    *,
    fx, fy, cx, cy,
) -> TriangulationResult:
    """Direct depth backprojection (reference: lvt_local_map.cpp:231-256).

    Depth validity ([near, far]) is enforced upstream at feature extraction
    (lvt_image_features_handler.cpp:255-263), so `valid` carries it here.
    """
    x = (uv[:, 0] - cx) * depth / fx
    y = (uv[:, 1] - cy) * depth / fy
    pts_cam = jnp.stack([x, y, depth], axis=-1)
    pts_world = se3.transform_points(pose.matrix34(), pts_cam)
    return TriangulationResult(pts_cam, pts_world, valid)
