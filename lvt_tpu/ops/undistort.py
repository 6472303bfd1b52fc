"""Lens distortion: point undistortion and image rectification remap.

Replacement for the reference's uses of OpenCV
``undistortPoints`` (RGB-D keypoints, lvt/src/lvt_image_features_handler.cpp:
268-295; image bounds, lvt_local_map.cpp:87-122) and
``initUndistortRectifyMap`` + ``remap`` (EuRoC rectification,
examples/euroc/euroc_example.cpp:106-107,142-143).

Model: the standard radial-tangential (Brown-Conrady) model with
(k1, k2, p1, p2, k3). Undistortion inverts it by fixed-point iteration
(the same scheme OpenCV uses), which is trivially batched under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def distort_normalized(xy: jnp.ndarray, k1, k2, p1, p2, k3) -> jnp.ndarray:
    """Apply the distortion model to normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(
    xy_dist: jnp.ndarray, k1, k2, p1, p2, k3, iters: int = 8
) -> jnp.ndarray:
    """Invert the distortion by fixed-point iteration (OpenCV-style)."""
    x0 = xy_dist

    def body(_, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return jnp.stack(
            [(x0[..., 0] - dx) / radial, (x0[..., 1] - dy) / radial], axis=-1
        )

    return jax.lax.fori_loop(0, iters, body, x0)


def undistort_points(
    pts: jnp.ndarray, fx, fy, cx, cy, k1, k2, p1, p2, k3
) -> jnp.ndarray:
    """Pixel -> undistorted pixel (same intrinsics), batched [..., 2]."""
    xn = (pts[..., 0] - cx) / fx
    yn = (pts[..., 1] - cy) / fy
    und = undistort_normalized(jnp.stack([xn, yn], -1), k1, k2, p1, p2, k3)
    return jnp.stack([und[..., 0] * fx + cx, und[..., 1] * fy + cy], axis=-1)


def undistorted_image_bounds(
    width: int, height: int, fx, fy, cx, cy, k1, k2, p1, p2, k3
) -> tuple[float, float, float, float]:
    """(min_x, max_x, min_y, max_y) from the four undistorted image corners,
    the host-side analogue of lvt_local_map's ctor (lvt_local_map.cpp:87-122).
    Returns plain floats for embedding as static config; evaluated eagerly
    even when called while a step is being traced."""
    if abs(k1) < 1e-5:
        return 0.0, float(width), 0.0, float(height)
    with jax.ensure_compile_time_eval():
        corners = jnp.array(
            [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
            jnp.float32,
        )
        und = np.asarray(
            undistort_points(corners, fx, fy, cx, cy, k1, k2, p1, p2, k3))
    min_x = float(min(und[0, 0], und[2, 0]))
    max_x = float(max(und[1, 0], und[3, 0]))
    min_y = float(min(und[0, 1], und[1, 1]))
    max_y = float(max(und[2, 1], und[3, 1]))
    return min_x, max_x, min_y, max_y


def make_rectify_map(
    width: int,
    height: int,
    k_mat: np.ndarray,       # [3,3] original intrinsics
    dist: np.ndarray,        # [5] (k1, k2, p1, p2, k3)
    r_rect: np.ndarray,      # [3,3] rectifying rotation
    p_new: np.ndarray,       # [3,3] new projection intrinsics
) -> np.ndarray:
    """Precompute the (x, y) source-pixel map for stereo rectification.

    Equivalent of cv::initUndistortRectifyMap: for each destination pixel,
    unproject through P_new, rotate by R^-1, distort, project through K.
    Returns [H, W, 2] float32 to be fed to `remap_bilinear`.
    """
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    ones = np.ones_like(xs)
    pix = np.stack([xs, ys, ones], axis=-1).astype(np.float64)  # [H, W, 3]
    inv_p = np.linalg.inv(p_new)
    rays = pix @ inv_p.T          # normalized in rectified frame
    rays = rays @ np.linalg.inv(r_rect).T
    xy = rays[..., :2] / rays[..., 2:3]
    xyd = np.asarray(
        distort_normalized(
            jnp.asarray(xy, jnp.float32),
            float(dist[0]), float(dist[1]), float(dist[2]),
            float(dist[3]), float(dist[4]),
        )
    )
    u = xyd[..., 0] * k_mat[0, 0] + k_mat[0, 2]
    v = xyd[..., 1] * k_mat[1, 1] + k_mat[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


@jax.jit
def remap_bilinear(img: jnp.ndarray, src_map: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sampling of img at src_map ([H, W, 2] (x, y)); out-of-bounds
    reads clamp to the border (cv::remap BORDER_CONSTANT differs only in the
    outermost pixels, which detection's border margin discards anyway)."""
    h, w = img.shape
    img = img.astype(jnp.float32)
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy
