"""Projection matching (map -> frame) and stereo row matching.

Re-design of the reference's two matching hot loops:

* ``find_map_matches`` == lvt_local_map::find_matches
  (lvt/src/lvt_local_map.cpp:136-229): project every map point, build a
  dense candidate mask (visibility x tracking radius x unmatched), match via
  one masked Hamming matrix, and — instead of the sequential "retry all
  visible points with doubled radius if < 50 matches" branch — evaluate both
  radii from the *same* distance matrix and select with `where`.

* ``row_match`` == lvt_image_features_handler::row_match +
  lvt_image_features_struct::row_match (lvt_image_features_handler.cpp:302-323,
  lvt_image_features_struct.cpp:122-148): match unmatched left features to
  unmatched right features within +-vertical_search_radius image rows.

Both run entirely on device with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lvt_tpu.core.features import FrameFeatures
from lvt_tpu.geometry import se3
from lvt_tpu.ops import hamming
from lvt_tpu.ops.collectives import por_if, psum_if


class MapMatchResult(NamedTuple):
    # per-map-point (all [M]):
    match_idx: jnp.ndarray    # feature index, -1 = visible but unmatched,
                              # -2 = invisible (reference encoding)
    projection: jnp.ndarray   # [M, 2] projected pixel position
    visible: jnp.ndarray      # [M] bool
    d1: jnp.ndarray           # best descriptor distance (for metrics)
    d2: jnp.ndarray           # second-best distance
    # per-feature:
    feature_matched: jnp.ndarray  # [K] bool, features claimed by a map point
    matches_count: jnp.ndarray    # [] int32
    used_wide_radius: jnp.ndarray  # [] bool (the 2x-radius fallback fired)


def dual_radius_top2(dist, q_uv, q_valid, t_kp, t_valid, radius_a, radius_b):
    """Masked top-2 under two radius predicates from one distance matrix
    (materialized masks + hamming.masked_top2_int)."""
    diff = t_kp[None, :, :] - q_uv[:, None, :]
    dr2 = jnp.sum(diff * diff, axis=-1)
    base = q_valid[:, None] & t_valid[None, :]
    out = []
    for radius in (radius_a, radius_b):
        if out and radius == radius_a:
            out.append(out[0])  # single-radius callers pass b == a
            break
        cand = base & (dr2 < jnp.float32(radius) ** 2)
        out.append(hamming.masked_top2_int(dist, cand))
    return tuple(out)


def _accept_resolve(top2, ratio_th, abs_th, num_feats, axis_name):
    d1, d2, best, n_cand = top2
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_th, abs_th)
    idx = hamming.resolve_one_to_one(idx, d1, num_feats, axis_name=axis_name)
    return idx, d1, d2


def find_map_matches(
    map_pos: jnp.ndarray,        # [M, 3] world positions
    map_desc: jnp.ndarray,       # [M, W] packed descriptors
    map_valid: jnp.ndarray,      # [M] bool
    pose,                        # predicted camera pose (se3.Pose)
    feats: FrameFeatures,
    *,
    fx, fy, cx, cy,
    near, far, min_x, max_x, min_y, max_y,
    tracking_radius: int,
    ratio_threshold: float,
    abs_threshold: float,
    retry_min_matches: int,      # LVT_N_MATCHES_TH == 50
    axis_name: str | None = None,  # map points sharded over this mesh axis
    matmul: bool = False,         # Hamming as a +-1 bf16 matrix product
) -> MapMatchResult:
    m = map_pos.shape[0]
    k = feats.kp.shape[0]

    w2c = se3.world_to_camera(pose)
    pts_cam = se3.transform_points(w2c, map_pos)
    uv = se3.project_points(pts_cam, fx, fy, cx, cy)
    visible = map_valid & se3.visibility_mask(
        pts_cam, uv, near, far, min_x, max_x, min_y, max_y
    )

    # one Hamming matrix serves both radius passes
    dist = hamming.hamming_matrix(map_desc, feats.desc,
                                  matmul=matmul)  # [M, K]

    top2_narrow, top2_wide = dual_radius_top2(
        dist, uv, visible, feats.kp, feats.valid,
        tracking_radius, 2 * tracking_radius,
    )
    idx1, d1a, d2a = _accept_resolve(
        top2_narrow, ratio_threshold, abs_threshold, k, axis_name)
    count1 = psum_if(jnp.sum(idx1 >= 0), axis_name)

    idx2, d1b, d2b = _accept_resolve(
        top2_wide, ratio_threshold, abs_threshold, k, axis_name)

    use_wide = count1 < retry_min_matches
    idx = jnp.where(use_wide, idx2, idx1)
    d1 = jnp.where(use_wide, d1b, d1a)
    d2 = jnp.where(use_wide, d2b, d2a)
    matches_count = psum_if(jnp.sum(idx >= 0), axis_name)

    match_idx = jnp.where(visible, jnp.where(idx >= 0, idx, -1), -2)

    feature_matched = jnp.zeros((k + 1,), bool)
    feature_matched = feature_matched.at[
        jnp.where(idx >= 0, idx, k)
    ].set(True)[:k]
    # one-to-one resolution already guarantees each feature has at most one
    # winner ACROSS shards, so the global claim mask is the OR of the shards'
    feature_matched = por_if(feature_matched, axis_name)
    # slot k absorbed the non-matches; make sure padding stays unmatched
    feature_matched = feature_matched & feats.valid

    return MapMatchResult(
        match_idx=match_idx,
        projection=uv,
        visible=visible,
        d1=d1,
        d2=d2,
        feature_matched=feature_matched,
        matches_count=matches_count,
        used_wide_radius=use_wide,
    )


class RowMatchResult(NamedTuple):
    right_idx: jnp.ndarray       # [K] per-left-feature right index, -1 = none
    left_matched: jnp.ndarray    # [K] bool
    right_matched: jnp.ndarray   # [K] bool
    count: jnp.ndarray           # [] int32


def row_match(
    left: FrameFeatures,
    right: FrameFeatures,
    left_excluded: jnp.ndarray,   # [K] bool, left features already tracked
    *,
    vertical_search_radius: int,
    ratio_threshold: float,       # triangulation ratio (0.6)
    abs_threshold: float,
    img_rows: int,
    dist: jnp.ndarray | None = None,  # optional precomputed Hamming [K, K]
    matmul: bool = False,
) -> RowMatchResult:
    """Greedy epipolar row matching, vectorized.

    Semantics of the reference candidate window: the left y coordinate is
    truncated to int and right candidates must satisfy
    floor(y_l) - r <= y_r <= floor(y_l) + r (clamped to the image)
    (lvt_image_features_struct.cpp:124-139).

    ``dist`` lets callers that row-match the same stereo pair twice with
    complementary exclusion masks (tracked features for BA observations,
    untracked for triangulation) build the Hamming matrix only once.
    """
    k = left.kp.shape[0]
    query_ok = left.valid & ~left_excluded

    y_l = jnp.floor(left.kp[:, 1])
    lo = jnp.maximum(y_l - vertical_search_radius, 0.0)
    hi = jnp.minimum(y_l + vertical_search_radius, float(img_rows))
    if dist is None:
        dist = hamming.hamming_matrix(left.desc, right.desc,
                                      matmul=matmul)

    y_r = right.kp[:, 1]
    cand = (
        query_ok[:, None]
        & right.valid[None, :]
        & (y_r[None, :] >= lo[:, None])
        & (y_r[None, :] <= hi[:, None])
    )
    d1, d2, best, n_cand = hamming.masked_top2_int(dist, cand)
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_threshold, abs_threshold)
    idx = hamming.resolve_one_to_one(idx, d1, k)

    left_matched = idx >= 0
    right_matched = jnp.zeros((k + 1,), bool).at[
        jnp.where(left_matched, idx, k)
    ].set(True)[:k] & right.valid
    return RowMatchResult(
        right_idx=idx,
        left_matched=left_matched,
        right_matched=right_matched,
        count=jnp.sum(left_matched),
    )
