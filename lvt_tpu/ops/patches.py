"""Per-keypoint patch extraction for the "patch" descriptor mode.

One contiguous 32x32 smoothed-image patch and one 8x8 raw-score patch per
keypoint, cut from the full maps with vmapped ``dynamic_slice``. Downstream,
descriptor formation is dense linear algebra on the patch tensor
(ops/brief.descriptors_from_patches) and subpixel refinement reads static
slices of the raw patches (ops/detect.subpixel_from_patches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PATCH = 32        # smooth patch extent; pool offsets live in [-15, 15]
PATCH_R0 = 15     # pool sample (dx, dy) maps to patch row PATCH_R0 + dy
PATCH_C0 = 16     # ... and patch col PATCH_C0 + dx
RAWP = 8          # raw-score patch extent (3x3 subpixel neighborhood + pad)
RAWP_R0 = 3       # corner center sits at raw patch (RAWP_R0, RAWP_C0)
RAWP_C0 = 4


def clamp_coords(x: jnp.ndarray, y: jnp.ndarray, hp: int, wp: int):
    """Clamp integer keypoint coords so both patch reads stay in-bounds of
    the [hp, wp] maps.  Valid keypoints (BRIEF border: 20 px) are never
    moved; invalid/padded selections produce in-bounds garbage that the
    validity mask kills downstream."""
    x = jnp.clip(x, PATCH_C0, wp - PATCH + PATCH_C0)   # [16, wp-16]
    y = jnp.clip(y, PATCH_R0, hp - PATCH + PATCH_R0)   # [15, hp-17]
    return x, y


def extract_patches_xla(
    smooth: jnp.ndarray, raw: jnp.ndarray,
    x: jnp.ndarray, y: jnp.ndarray, valid: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[B, H, W] maps and [B, K] pre-clamped coords (clamp_coords) ->
    ([B, K, 32, 32] smooth, [B, K, 8, 8] raw) patches; invalid slots come
    back zeroed."""

    def one(sm, rw, xs, ys, vs):
        p = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
            sm, (yy - PATCH_R0, xx - PATCH_C0), (PATCH, PATCH)))(ys, xs)
        rp = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
            rw, (yy - RAWP_R0, xx - RAWP_C0), (RAWP, RAWP)))(ys, xs)
        return (jnp.where(vs[:, None, None], p, 0.0),
                jnp.where(vs[:, None, None], rp, 0.0))

    return jax.vmap(one)(smooth.astype(jnp.float32), raw.astype(jnp.float32),
                         x, y, valid)
