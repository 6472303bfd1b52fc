"""Feature extraction stage: detection + description (+ RGB-D filtering).

Equivalent of the reference's ``lvt_image_features_handler``
(lvt/src/lvt_image_features_handler.cpp:131-300). The reference processes the
two stereo images on two CPU threads (:196-209); here any number of images is
one batch axis of the same computation (the stereo pair and multi-stream
batches are flattened into it). Score maps and BRIEF bit-planes are
plain-JAX shifted-slice stencils compiled by XLA. All outputs are padded to the static
keypoint capacity with validity masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lvt_tpu.config import VOConfig
from lvt_tpu.core.features import FrameFeatures
from lvt_tpu.ops import brief, detect, undistort
from lvt_tpu.ops import patches as patches_mod


def _pad_to(arr: jnp.ndarray, capacity: int, axis: int = 0) -> jnp.ndarray:
    n = arr.shape[axis]
    if n == capacity:
        return arr
    assert n < capacity, f"detector output {n} exceeds capacity {capacity}"
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, capacity - n)
    return jnp.pad(arr, pad)


def _gather_mode(config: VOConfig) -> str:
    if config.gather_mode is not None:
        return config.gather_mode
    return "scatter"


def _descriptor_mode(config: VOConfig) -> str:
    """Resolve config.descriptor_mode (see config.py for the matrix)."""
    if config.descriptor_mode is not None:
        return config.descriptor_mode
    return "dense" if config.use_dense_brief else "sparse"


def perception_batched(imgs: jnp.ndarray, mode: str):
    """[B, H, W] -> (raw_score, nms_score [B, H, W], aux) where aux is the
    packed dense bit-planes [B, 8, H, W] ("dense" mode) or the smoothed
    image [B, H, W] (otherwise)."""

    def one(img):
        img = img.astype(jnp.float32)
        raw = detect.fast_score_map(img)
        smooth = brief.box_smooth(img)
        aux = (brief.dense_descriptor_planes(smooth)
               if mode == "dense" else smooth)
        return raw, detect.nms3x3(raw), aux

    return jax.vmap(one)(imgs)


def _select_and_describe(raw, nms, aux, config: VOConfig,
                         mode: str, spread_ties: bool) -> FrameFeatures:
    """Per-image selection + descriptor gather (vmappable).

    Descriptors sample at the detected integer corner (``det.kp_int``) —
    the reference's behavior (OpenCV BRIEF at the integer AGAST keypoint,
    lvt_image_features_handler.cpp:171-175); the subpixel-refined position
    is the geometric observation only. This keeps every descriptor mode
    (dense / sparse / patch) bit-identical at valid keypoints."""
    gmode = _gather_mode(config)
    det = detect.select_corners(
        raw, nms, config.agast_threshold,
        cell_size=config.detection_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        corners_low_threshold=config.corners_low_threshold,
        gather_mode=gmode, spread_ties=spread_ties,
    )
    kp_det = det.kp_int.astype(jnp.float32)
    if mode == "sparse":
        desc, valid = brief.descriptors_sparse(aux, kp_det, det.valid)
    elif gmode == "flat":
        desc, valid = brief.descriptors_from_planes_flat(
            aux, kp_det, det.valid)
    elif gmode == "slice":
        desc, valid = brief.descriptors_from_planes_slice8(
            aux, kp_det, det.valid)
    else:
        desc, valid = brief.descriptors_from_planes(aux, kp_det, det.valid)
    cap = config.kp_capacity
    return FrameFeatures(
        kp=_pad_to(det.kp, cap),
        desc=_pad_to(desc, cap),
        score=_pad_to(det.score, cap),
        depth=jnp.zeros((cap,), jnp.float32),
        valid=_pad_to(valid, cap),
    )


def _extract_patch_mode(imgs: jnp.ndarray, config: VOConfig) -> FrameFeatures:
    """Select on the NMS map, then cut one smooth and one raw-score patch
    per keypoint (ops/patches); descriptors come from exact one-hot
    matmuls on the patches and subpixel refinement from static slices."""
    bsz, h, w = imgs.shape
    spread_ties = _spread_ties(imgs)
    with jax.named_scope("perception"):
        raw, nms, smooth = perception_batched(imgs, "patch")
    with jax.named_scope("corner_select"):
        det = jax.vmap(lambda n: detect.select_corners(
            n, n, config.agast_threshold,
            cell_size=config.detection_cell_size,
            max_per_cell=config.max_keypoints_per_cell,
            corners_low_threshold=config.corners_low_threshold,
            subpixel=False,
            spread_ties=spread_ties,
        ))(nms)
    # pad the [B, K] selection arrays (tiny), never the [B, K, 32, 32]
    # patch tensor
    cap = config.kp_capacity

    def pad(a):
        return _pad_to(a, cap, axis=1)

    xi = pad(det.kp_int[..., 0])
    yi = pad(det.kp_int[..., 1])
    sel_valid = pad(det.valid)
    hp, wp = smooth.shape[1:]
    xc, yc = patches_mod.clamp_coords(xi, yi, hp, wp)
    with jax.named_scope("patch_extract"):
        patches, rawp = patches_mod.extract_patches_xla(
            smooth, raw, xc, yc, sel_valid)
    with jax.named_scope("describe_refine"):
        desc, valid = jax.vmap(
            lambda p, xx, yy, v: brief.descriptors_from_patches(
                p, xx, yy, v, h, w)
        )(patches, xi, yi, sel_valid)
        xf, yf = detect.subpixel_from_patches(rawp, xi, yi)
        kp = jnp.stack([xf, yf], axis=-1)
    return FrameFeatures(
        kp=kp, desc=desc, score=pad(det.score),
        depth=jnp.zeros((bsz, cap), jnp.float32), valid=valid,
    )


def _spread_ties(imgs: jnp.ndarray) -> bool:
    """Plateau-dither selection only for integer-valued frames (uint8):
    on float frames (e.g. the fused-rectify path's bilinear output) the
    dither would outrank genuine sub-unit score differences — see
    ops/detect.select_corners."""
    return imgs.dtype == jnp.uint8


def extract_features_batched(imgs: jnp.ndarray, config: VOConfig) -> FrameFeatures:
    """[B, H, W] images -> batched FrameFeatures [B, kp_capacity]."""
    mode = _descriptor_mode(config)
    if mode == "patch":
        return _extract_patch_mode(imgs, config)
    spread = _spread_ties(imgs)
    with jax.named_scope("perception"):
        raw, nms, planes = perception_batched(imgs, mode)
    with jax.named_scope("corner_select_describe"):
        return jax.vmap(
            lambda r, n, p: _select_and_describe(r, n, p, config, mode,
                                                 spread)
        )(raw, nms, planes)


def extract_features(img: jnp.ndarray, config: VOConfig) -> FrameFeatures:
    """Detect + describe one grayscale image -> FrameFeatures [kp_capacity]."""
    feats = extract_features_batched(img[None], config)
    return jax.tree.map(lambda a: a[0], feats)


def extract_features_stereo(
    img_left: jnp.ndarray, img_right: jnp.ndarray, config: VOConfig
) -> tuple[FrameFeatures, FrameFeatures]:
    """Both stereo images as one batch dim (replaces the reference's
    std::thread split, lvt_image_features_handler.cpp:196-209)."""
    feats = extract_features_batched(jnp.stack([img_left, img_right]), config)
    left = jax.tree.map(lambda a: a[0], feats)
    right = jax.tree.map(lambda a: a[1], feats)
    return left, right


def extract_features_rgbd(
    img_gray: jnp.ndarray, img_depth: jnp.ndarray, config: VOConfig
) -> FrameFeatures:
    """RGB-D path: detect + describe, then keep only keypoints with valid
    depth in [near, far], undistorting positions if k1 != 0
    (lvt_image_features_handler.cpp:227-300). Fixed shapes: filtering clears
    the validity mask instead of compacting."""
    feats = extract_features(img_gray, config)
    xi = jnp.clip(feats.kp[:, 0].astype(jnp.int32), 0, config.img_width - 1)
    yi = jnp.clip(feats.kp[:, 1].astype(jnp.int32), 0, config.img_height - 1)
    d = img_depth[yi, xi]
    depth_ok = (d >= config.near_plane_distance) & (d <= config.far_plane_distance)
    valid = feats.valid & depth_ok

    if abs(config.k1) > 1e-5:
        kp_und = undistort.undistort_points(
            feats.kp,
            config.fx, config.fy, config.cx, config.cy,
            config.k1, config.k2, config.p1, config.p2, config.k3,
        )
    else:
        kp_und = feats.kp
    return feats._replace(kp=kp_und, depth=d, valid=valid)


def describe_external_corners(
    img: jnp.ndarray,
    corners: jnp.ndarray,       # [N, 2] float32 caller-provided positions
    corners_valid: jnp.ndarray,  # [N] bool
    config: VOConfig,
) -> FrameFeatures:
    """Descriptors-only path for externally supplied corners
    (== compute_descriptors_only, lvt_image_features_handler.cpp:178-225,
    exposed through track_with_external_corners)."""
    desc, valid = brief.compute_descriptors(img, corners, corners_valid)
    cap = config.kp_capacity
    return FrameFeatures(
        kp=_pad_to(corners.astype(jnp.float32), cap),
        desc=_pad_to(desc, cap),
        score=jnp.zeros((cap,), jnp.float32),
        depth=jnp.zeros((cap,), jnp.float32),
        valid=_pad_to(valid, cap),
    )
