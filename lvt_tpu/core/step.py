"""The jitted per-frame tracking step — the unit of execution.

Re-design of the reference's per-frame pipeline
(lvt_system::track -> perform_tracking, lvt/src/lvt_system.cpp:157-306, and
lvt_local_map's matching/staging/triangulation calls): the whole frame —
feature extraction, motion prediction, map matching, LM PnP, counter
bookkeeping, culling, staged-point promotion, triangulation policy, stereo
row-matching, triangulation and map insertion — is ONE pure function

    track_step(state, frame) -> (state', pose, metrics)

compiled once per (config, shapes). The reference's state machine
(NOT_INITIALIZED / TRACKING / LOST) becomes ONE predicated tracking body —
the init frame IS a tracking frame over an empty map with forced-identity
prediction and triangulation forced on, the lost frame a pure output select
(see track_features) — and its retry/policy branches become masks and
`where` selects (always computed, conditionally selected). The
host<->device boundary is image-in / pose-out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lvt_tpu.config import MATCHES_WINDOW_INIT, VOConfig
from lvt_tpu.core import extract
from lvt_tpu.core import map as map_ops
from lvt_tpu.core.features import FrameFeatures
from lvt_tpu.core.motion import predict_next_pose
from lvt_tpu.core.state import (
    LOST,
    NOT_INITIALIZED,
    TRACKING,
    ObsWindow,
    PointStore,
    StepMetrics,
    VOState,
)
from lvt_tpu.geometry import se3
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.ops import hamming, matching, triangulate
from lvt_tpu.ops.collectives import psum_if as _psum_if
from lvt_tpu.solver.pnp import solve_pnp


def _select(pred, a, b):
    """Elementwise pytree select on a scalar predicate."""
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _shard_partition_mask(insert_mask: jnp.ndarray, axis_name) -> jnp.ndarray:
    """Partition replicated insertion candidates across shards so each
    point lands in exactly one map shard, balanced by the candidates'
    *valid rank* (round-robin over feature index would let clustered
    candidates overfill one shard while others stay empty)."""
    if axis_name is None:
        return insert_mask
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    rank = jnp.cumsum(insert_mask.astype(jnp.int32)) - 1
    return insert_mask & ((rank % n) == i)


def _image_bounds(config: VOConfig) -> tuple[float, float, float, float]:
    """Visible pixel bounds; for distorted RGB-D input these are the
    undistorted corners (computed host-side, lvt_local_map.cpp:87-122)."""
    from lvt_tpu.ops.undistort import undistorted_image_bounds

    return undistorted_image_bounds(
        config.img_width, config.img_height,
        config.fx, config.fy, config.cx, config.cy,
        config.k1, config.k2, config.p1, config.p2, config.k3,
    )


def _camera_kwargs(config: VOConfig) -> dict:
    min_x, max_x, min_y, max_y = _image_bounds(config)
    return dict(
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        near=config.near_plane_distance, far=config.far_plane_distance,
        min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
    )


def _triangulate_new_points(
    left: FrameFeatures,
    right: FrameFeatures | None,
    feature_matched: jnp.ndarray,
    pose: Pose,
    config: VOConfig,
    rgbd: bool,
    row_dist: jnp.ndarray | None = None,
):
    """Row-match + triangulate (stereo) or backproject (RGB-D).

    Returns (points_world [K,3], desc [K,W], valid [K]).
    Note the RGB-D path backprojects *every* depth-valid feature, matched or
    not, exactly like the reference (lvt_local_map.cpp:231-256 has no
    matched-mark check) — duplicates are culled by the untracked counter.
    """
    cam = _camera_kwargs(config)
    if rgbd:
        res = triangulate.backproject_rgbd(
            left.kp, left.depth, left.valid, pose,
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        )
        return res.points_world, left.desc, res.valid
    rm = matching.row_match(
        left, right, feature_matched,
        vertical_search_radius=config.row_matching_vertical_search_radius,
        ratio_threshold=config.triangulation_ratio_test_threshold,
        abs_threshold=config.descriptor_matching_threshold,
        img_rows=config.img_height,
        dist=row_dist,
        matmul=config.hamming_matmul,
    )
    k = left.kp.shape[0]
    uv_right = right.kp[jnp.clip(rm.right_idx, 0, k - 1)]
    res = triangulate.triangulate_stereo(
        left.kp, uv_right, rm.left_matched, pose,
        baseline=config.baseline,
        reprojection_th2=config.reprojection_th2,
        **cam,
    )
    return res.points_world, left.desc, res.valid


def _policy_need_triangulation(
    config: VOConfig, window: jnp.ndarray, map_size: jnp.ndarray
) -> jnp.ndarray:
    """Triangulation policies (lvt_system.cpp:313-334). `window` is
    oldest-first [3] float32 including the current frame's match count."""
    if config.triangulation_policy == 2:  # always triangulate
        return jnp.asarray(True)
    if config.triangulation_policy == 3:  # map size
        return map_size < 1000
    # decreasing matches: every newer count must be <= 0.99 * previous
    ratio = jnp.float32(0.99)
    ok01 = window[1] <= ratio * window[0]
    ok12 = window[2] <= ratio * window[1]
    return ok01 & ok12


def _staged_update(
    staged: PointStore,
    pose: Pose,
    feats: FrameFeatures,
    feature_matched: jnp.ndarray,
    map_size: jnp.ndarray,
    config: VOConfig,
    axis_name: str | None = None,
):
    """Re-match staged points against the remaining unmatched features;
    delete misses, promote survivors (lvt_local_map.cpp:355-391).

    Returns (staged', promotion candidates for map insertion, feature marks).
    Promoted points carry their staging counter into the map — faithfully
    reproducing the reference, which copies the whole lvt_map_point on
    promotion, counter included (:371-376).
    """
    cam = _camera_kwargs(config)
    k = feats.kp.shape[0]
    w2c = se3.world_to_camera(pose)
    pts_cam = se3.transform_points(w2c, staged.pos)
    uv = se3.project_points(pts_cam, config.fx, config.fy, config.cx, config.cy)
    visible = staged.valid & se3.visibility_mask(
        pts_cam, uv, cam["near"], cam["far"],
        cam["min_x"], cam["max_x"], cam["min_y"], cam["max_y"],
    )
    dist = hamming.hamming_matrix(staged.desc, feats.desc,
                                  matmul=config.hamming_matmul)
    (d1, d2, best, n_cand), _ = matching.dual_radius_top2(
        dist, uv, visible, feats.kp,
        feats.valid & jnp.logical_not(feature_matched),
        config.tracking_radius, config.tracking_radius,
    )
    idx = hamming.accept_matches(
        d1, d2, best, n_cand,
        config.tracking_ratio_test_threshold,
        config.descriptor_matching_threshold,
    )
    idx = hamming.resolve_one_to_one(idx, d1, k, axis_name=axis_name)
    matched = idx >= 0

    new_marks = jnp.zeros((k + 1,), bool).at[
        jnp.where(matched, idx, k)
    ].set(True)[:k]
    feature_matched = feature_matched | matching.por_if(new_marks, axis_name)

    ctr_next = staged.counter + 1
    promote = staged.valid & matched & (
        (ctr_next == config.staged_threshold) | (map_size < config.map_soft_cap)
    )
    remain = staged.valid & matched & jnp.logical_not(promote)
    staged_out = staged._replace(
        counter=jnp.where(matched, ctr_next, staged.counter),
        valid=remain,
    )
    promo = (staged.pos, staged.desc, jnp.where(matched, ctr_next, staged.counter),
             staged.age, promote)
    return staged_out, promo, feature_matched


def _local_ba_update(
    ba: ObsWindow,
    map_store: PointStore,
    pose_opt: Pose,
    obs_new: jnp.ndarray,       # [M, 2] this frame's left observation per slot
    w_new: jnp.ndarray,         # [M] observation validity
    obs_r_new: jnp.ndarray,     # [M, 2] right-camera observation per slot
    w_r_new: jnp.ndarray,       # [M]
    slots_invalidated: jnp.ndarray,  # [M] culled or recycled this frame
    frame_number: jnp.ndarray,
    config: VOConfig,
    axis_name: str | None = None,
):
    """Slide the observation window and periodically run windowed BA
    (lvt_tpu.solver.bundle) over the last F poses + map structure.

    Returns (window', refined pose, refined map positions). Opt-in feature
    with no reference counterpart. Stereo (right-camera) observations are
    essential here: with mono observations over a short window, point depth
    is near-unobservable and the Schur update can send points far along
    their rays — the baseline pins depth. A relative step clamp guards the
    writeback regardless."""
    from lvt_tpu.solver.bundle import (chi2_gate_weights, refine_window,
                                       weighted_point_e2)

    f_win = config.local_ba_window
    alive = (map_store.valid & ~slots_invalidated)[None, :].astype(jnp.float32)
    obs = jnp.concatenate([ba.obs[1:], obs_new[None]], 0)
    w = jnp.concatenate([ba.w[1:], w_new[None]], 0) * alive
    obs_r = jnp.concatenate([ba.obs_r[1:], obs_r_new[None]], 0)
    w_r = jnp.concatenate([ba.w_r[1:], w_r_new[None]], 0) * alive
    poses_t = jnp.concatenate([ba.poses_t[1:], pose_opt.t[None]], 0)
    poses_q = jnp.concatenate([ba.poses_q[1:], pose_opt.q[None]], 0)
    n = jnp.minimum(ba.n + 1, f_win)

    do_ba = (n >= f_win) & (frame_number % config.local_ba_every == 0)

    def run(args):
        poses_t, poses_q, obs, w, obs_r, w_r, pos = args
        # per-observation chi2 gate BEFORE refinement (solver.bundle.
        # chi2_gate_weights): mismatched associations — the r4 failure mode
        # that made BA hurt on dense texture — are cut at the window's own
        # residual scale, so the counts below see only trusted observations
        w, w_r = chi2_gate_weights(
            Pose(poses_t, poses_q), pos, obs, w,
            baseline=config.baseline, obs_right=obs_r, w_right=w_r,
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
            psum_axis=axis_name,
        )
        # constrain only points with >= 2 left observations AND at least one
        # stereo pair (depth anchored)
        n_l = jnp.sum(w > 0, axis=0)
        n_s = jnp.sum((w > 0) & (w_r > 0), axis=0)
        use = ((n_l >= 2) & (n_s >= 1)).astype(jnp.float32)
        res = refine_window(
            Pose(poses_t, poses_q), pos, obs, w * use[None, :],
            baseline=config.baseline,
            obs_right=obs_r, w_right=w_r * use[None, :],
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
            iterations=config.local_ba_iterations,
            reprojection_th2=config.reprojection_th2,
            psum_axis=axis_name,
            # the stereo baseline already pins scale, so a single fixed pose
            # fully determines the gauge (fixing more anchors pose error)
            n_fixed_poses=1,
        )
        # writeback guards: (1) relative trust region — a refined point may
        # not move more than 10% of its distance to the camera (+0.5m);
        # (2) improvement test — the trajectory stays the PnP output, so a
        # refined point is kept only if it fits the (gated) observations
        # better under the ORIGINAL window poses than the old point did
        dist = jnp.linalg.norm(pos - poses_t[-1][None, :], axis=-1)
        step_norm = jnp.linalg.norm(res.points - pos, axis=-1)
        ok = use > 0
        ok &= step_norm <= 0.1 * dist + 0.5
        e2_args = dict(
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
            baseline=config.baseline, obs_right=obs_r,
            w_right=w_r * use[None, :],
        )
        e2_old = weighted_point_e2(
            Pose(poses_t, poses_q), pos, obs, w * use[None, :], **e2_args)
        e2_new = weighted_point_e2(
            Pose(poses_t, poses_q), res.points, obs, w * use[None, :],
            **e2_args)
        ok &= e2_new <= e2_old
        return jnp.where(ok[:, None], res.points, pos)

    def skip(args):
        return args[6]

    map_pos = jax.lax.cond(
        do_ba, run, skip, (poses_t, poses_q, obs, w, obs_r, w_r, map_store.pos)
    )
    window = ObsWindow(poses_t=poses_t, poses_q=poses_q, obs=obs, w=w,
                       obs_r=obs_r, w_r=w_r, n=n)
    # structure-only writeback: refined map points sharpen future matching
    # and PnP; the trajectory itself stays the PnP output (writing back
    # window poses was measurably noisier on synthetic sequences because the
    # gauge anchors to *estimated* past poses)
    return window, Pose(poses_t[-1], poses_q[-1]), map_pos


def _track_branch(
    state: VOState,
    left: FrameFeatures,
    right: FrameFeatures | None,
    config: VOConfig,
    rgbd: bool,
    is_init: jnp.ndarray,
    axis_name: str | None = None,
):
    """Normal tracking frame (perform_tracking, lvt_system.cpp:252-306) —
    and, via the ``is_init`` predicate, the first/initialization frame
    (lvt_system.cpp:185-193) as the SAME computation.

    The init frame is exactly a tracking frame over an empty map (the
    NOT_INITIALIZED invariant: map, staged, BA window and motion velocities
    are all empty/zero) at a forced-identity pose with triangulation forced
    on: matching over an all-invalid map yields zero matches, PnP with zero
    weights returns its prediction, bookkeeping over empty stores is a
    no-op, and every feature row-matches/triangulates into the map at
    identity — the reference's init path. A handful of scalar `where`
    selects (prediction, is_tracking, policy, match window, metrics)
    express the differences, so the vmapped multistream path compiles ONE
    body instead of lax.switch's compute-all-branches duplication of the
    row-match + triangulation chain.

    With ``axis_name`` set (sharded-map stream mode, BASELINE config 5) the
    map/staged stores are blocks of a mesh-sharded whole: feature-space
    arrays stay replicated, per-point work is local, and the cross-shard
    quantities (match counts, one-to-one claims, PnP normal equations, map
    sizes) reduce over the mesh with psum/pmin inside the enclosing shard_map
    (parallel/sharded_stream.py).

    Pipeline stages carry jax.named_scope markers so profiler traces
    (observability.profile_trace / xprof) attribute ops to the same stage
    names the reference's trace log brackets (lvt_system.cpp:263-297)."""
    cam = _camera_kwargs(config)
    k = left.kp.shape[0]
    identity = Pose.identity()

    # motion prediction mutates velocity state regardless of the outcome
    # (lvt_motion_model.cpp:42-65 updates on every call); the init frame
    # anchors the world at identity and leaves the motion state untouched
    with jax.named_scope("motion_predict"):
        motion, predicted = predict_next_pose(state.motion, state.pose)
        predicted = _select(is_init, identity, predicted)
        motion = _select(is_init, state.motion, motion)

    with jax.named_scope("map_matching"):
        mm = matching.find_map_matches(
            state.map.pos, state.map.desc, state.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold,
            axis_name=axis_name,
            matmul=config.hamming_matmul,
            **cam,
        )
    matches_count = mm.matches_count
    is_tracking = (
        matches_count >= config.min_num_matches_for_tracking
    ) | is_init

    # --- PnP on the matched 2D-3D pairs
    obs = left.kp[jnp.clip(mm.match_idx, 0, k - 1)]
    weights = (mm.match_idx >= 0).astype(jnp.float32)
    with jax.named_scope("pnp_solve"):
        pnp = solve_pnp(
            predicted, state.map.pos, obs, weights,
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
            reprojection_th2=config.reprojection_th2,
            axis_name=axis_name,
        )
    # zero matches leave LM at its prediction; the select makes the init
    # anchor exactly identity regardless of damping arithmetic
    pose_opt = _select(is_init, identity, pnp.pose)

    # --- bookkeeping (applies even when tracking fails: the reference's
    # find_matches already mutated counters before the early return)
    with jax.named_scope("map_bookkeeping"):
        map_bookkept = map_ops.apply_match_bookkeeping(state.map, mm.match_idx)

        # --- full update path (only selected when tracking holds)
        map_clean, feature_matched = map_ops.clean_untracked(
            map_bookkept, mm.match_idx, mm.feature_matched,
            config.untracked_threshold, axis_name=axis_name,
        )
    map_size = _psum_if(map_clean.size(), axis_name)

    if config.staged_threshold > 0:
        with jax.named_scope("staged_update"):
            staged_out, promo, feature_matched = _staged_update(
                state.staged, pose_opt, left, feature_matched, map_size,
                config, axis_name=axis_name,
            )
            p_pos, p_desc, p_ctr, p_age, p_mask = promo
            ins_promo = map_ops.insert_points(
                map_clean, p_pos, p_desc, p_mask, new_counter=p_ctr,
                new_age=p_age,
            )
        map_after_promo = ins_promo.store
    else:
        staged_out = state.staged
        map_after_promo = map_clean

    # --- triangulation policy + new points
    window = jnp.concatenate(
        [state.last_matches[1:], matches_count[None].astype(jnp.float32)]
    )
    map_size_after_promo = _psum_if(map_after_promo.size(), axis_name)
    need_tri = _policy_need_triangulation(
        config, window, map_size_after_promo) | is_init

    # one stereo Hamming matrix serves both the local-BA row match (over
    # tracked features, below) and the triangulation row match (over
    # untracked features) — complementary exclusion masks of the same pair
    want_ba_rm = (
        config.local_ba_window > 0 and not rgbd and config.baseline != 0.0
    )
    row_dist = (
        hamming.hamming_matrix(left.desc, right.desc,
                               matmul=config.hamming_matmul)
        if want_ba_rm else None
    )

    with jax.named_scope("triangulation"):
        pts, desc, tri_valid = _triangulate_new_points(
            left, right, feature_matched, pose_opt, config, rgbd,
            row_dist=row_dist,
        )
        tri_valid = tri_valid & need_tri
        # destination: map directly if staging disabled or map below soft
        # cap, else the staging buffer (lvt_local_map.cpp:343-352); in
        # sharded mode each shard inserts a rank-balanced subset
        tri_valid = _shard_partition_mask(tri_valid, axis_name)
        to_map = (config.staged_threshold == 0) | (
            map_size_after_promo < config.map_soft_cap
        )
        ins_map = map_ops.insert_points(
            map_after_promo, pts, desc, tri_valid & to_map
        )
        ins_staged = map_ops.insert_points(
            staged_out, pts, desc, tri_valid & jnp.logical_not(to_map)
        )

    # --- optional sliding-window local BA (structure + pose refinement)
    final_map = ins_map.store
    pose_final = pose_opt
    ba_window = state.ba
    if config.local_ba_window > 0:
        removed = map_bookkept.valid & ~map_clean.valid
        recycled = ins_map.taken
        if config.staged_threshold > 0:
            recycled = recycled | ins_promo.taken
        obs_new = left.kp[jnp.clip(mm.match_idx, 0, k - 1)]
        w_new = (mm.match_idx >= 0).astype(jnp.float32)
        if not want_ba_rm:
            # no right camera: stereo anchoring unavailable, BA inert
            obs_r_new = jnp.zeros_like(obs_new)
            w_r_new = jnp.zeros_like(w_new)
        else:
            # right-camera observations of the *tracked* features: epipolar
            # row match restricted to exactly the map-matched features,
            # reusing the Hamming matrix computed for triangulation above
            rm_ba = matching.row_match(
                left, right, jnp.logical_not(mm.feature_matched),
                vertical_search_radius=config.row_matching_vertical_search_radius,
                ratio_threshold=config.triangulation_ratio_test_threshold,
                abs_threshold=config.descriptor_matching_threshold,
                img_rows=config.img_height,
                dist=row_dist,
                matmul=config.hamming_matmul,
            )
            r_idx = rm_ba.right_idx[jnp.clip(mm.match_idx, 0, k - 1)]
            obs_r_new = right.kp[jnp.clip(r_idx, 0, k - 1)]
            w_r_new = ((mm.match_idx >= 0) & (r_idx >= 0)).astype(jnp.float32)
        with jax.named_scope("local_ba"):
            ba_window, pose_final, refined_pos = _local_ba_update(
                state.ba, final_map, pose_opt, obs_new, w_new,
                obs_r_new, w_r_new,
                removed | recycled, state.frame_number, config,
                axis_name=axis_name,
            )
        final_map = final_map._replace(pos=refined_pos)

    # --- select tracked vs lost outcomes; the init frame resets the
    # triangulation-policy window to [map size, INF, INF]
    # (lvt_system.cpp:185-193, m_last_matches initialization)
    map_size_final = _psum_if(ins_map.store.size(), axis_name)
    init_window = jnp.stack(
        [map_size_final.astype(jnp.float32),
         jnp.float32(MATCHES_WINDOW_INIT), jnp.float32(MATCHES_WINDOW_INIT)]
    )
    window = _select(is_init, init_window, window)
    new_state = VOState(
        map=_select(is_tracking, final_map, map_bookkept),
        staged=_select(is_tracking, ins_staged.store, state.staged),
        pose=_select(is_tracking, pose_final, state.pose),
        motion=motion,
        last_matches=_select(is_tracking, window, state.last_matches),
        frame_number=state.frame_number + 1,
        status=jnp.where(is_tracking, TRACKING, LOST).astype(jnp.int32),
        ba=_select(is_tracking & ~is_init, ba_window, state.ba),
    )
    out_pose = _select(is_tracking, pose_final, state.pose)

    matched_mask = mm.match_idx >= 0
    n_matched = jnp.maximum(matches_count, 1)
    mean_of = lambda v: _psum_if(
        jnp.sum(jnp.where(matched_mask, v, 0.0)), axis_name
    ) / n_matched
    metrics = StepMetrics(
        map_points_count=_select(
            is_init, map_size_final,
            _psum_if(state.map.size(), axis_name)).astype(jnp.int32),
        staged_points_count=_psum_if(
            state.staged.size(), axis_name).astype(jnp.int32),
        image_keypoints=left.count().astype(jnp.int32),
        tracked_map_points=matches_count.astype(jnp.int32),
        mean_age=mean_of(map_bookkept.age.astype(jnp.float32)),
        mean_closest_descriptor_distance=mean_of(mm.d1),
        mean_second_descriptor_distance=mean_of(mm.d2),
        mean_feature_x=mean_of(obs[:, 0]),
        mean_feature_y=mean_of(obs[:, 1]),
        inlier_count=pnp.inlier_count.astype(jnp.int32),
        triangulated_points=jnp.where(
            is_tracking,
            _psum_if(ins_map.n_inserted + ins_staged.n_inserted, axis_name),
            0,
        ).astype(jnp.int32),
        used_wide_radius=mm.used_wide_radius & ~is_init,
        status=new_state.status,
    )
    return new_state, out_pose, metrics


def track_features(
    state: VOState,
    left: FrameFeatures,
    right: FrameFeatures | None,
    config: VOConfig,
    rgbd: bool,
    axis_name: str | None = None,
):
    """Status dispatch over already-extracted features.

    The reference's three-state machine (lvt_system.cpp:157-207) is ONE
    predicated computation, not a lax.switch: under vmap (multistream,
    BASELINE config 4) a switch lowers to compute-all-branches + select, so
    every batched frame would pay the init branch's full row-match +
    triangulate-everything chain on top of the tracking branch. Instead the
    init frame runs *through* the tracking body (see _track_branch) and the
    lost frame — return last pose, bump the frame counter
    (lvt_system.cpp:161-166) — is a pure output select.

    ``axis_name`` marks the map/staged/ba leaves of ``state`` as blocks
    sharded over that mesh axis (call inside shard_map; the status scalar is
    replicated, so every shard computes the same predicates and the
    collectives inside line up)."""
    is_init = state.status == NOT_INITIALIZED
    is_lost = state.status == LOST
    tracked_state, pose, metrics = _track_branch(
        state, left, right, config, rgbd, is_init, axis_name
    )
    lost_state = state._replace(frame_number=state.frame_number + 1)
    lost_metrics = StepMetrics.zero()._replace(
        map_points_count=_psum_if(
            state.map.size(), axis_name).astype(jnp.int32),
        status=jnp.asarray(LOST, jnp.int32),
    )
    return (
        _select(is_lost, lost_state, tracked_state),
        _select(is_lost, state.pose, pose),
        _select(is_lost, lost_metrics, metrics),
    )


def _track_frame_stereo(state, img_left, img_right, config):
    left, right = extract.extract_features_stereo(img_left, img_right, config)
    return track_features(state, left, right, config, rgbd=False)


def _track_frame_rgbd(state, img_gray, img_depth, config):
    left = extract.extract_features_rgbd(img_gray, img_depth, config)
    return track_features(state, left, None, config, rgbd=True)


@functools.partial(jax.jit, static_argnames=("config",))
def track_step_stereo(
    state: VOState, img_left: jnp.ndarray, img_right: jnp.ndarray,
    config: VOConfig,
):
    """Full stereo frame: extraction + tracking, one compiled program."""
    return _track_frame_stereo(state, img_left, img_right, config)


@functools.partial(jax.jit, static_argnames=("config",))
def track_step_rgbd(
    state: VOState, img_gray: jnp.ndarray, img_depth: jnp.ndarray,
    config: VOConfig,
):
    """Full RGB-D frame (lvt_system.cpp:176-181 + rgbd paths)."""
    return _track_frame_rgbd(state, img_gray, img_depth, config)


@functools.partial(jax.jit, static_argnames=("config",))
def track_chunk_stereo(
    state: VOState,
    imgs_left: jnp.ndarray,   # [N, H, W] (uint8 or float32)
    imgs_right: jnp.ndarray,  # [N, H, W]
    config: VOConfig,
):
    """Scan the track step over a chunk of N frames entirely on device.

    The online mode (track_step_stereo) pays one host dispatch per frame; for
    offline/batch processing (dataset runs, benchmarking) this amortizes it
    to one dispatch per chunk — frames go up as one batch, the VOState never
    leaves the device between frames, and N poses come back together.
    Returns (state, poses [N], metrics [N]).
    """

    def body(s, frame):
        il, ir = frame
        s2, pose, metrics = _track_frame_stereo(s, il, ir, config)
        return s2, (pose, metrics)

    state, (poses, metrics) = jax.lax.scan(body, state, (imgs_left, imgs_right))
    return state, poses, metrics


@functools.partial(jax.jit, static_argnames=("config",))
def track_chunk_rgbd(
    state: VOState,
    imgs_gray: jnp.ndarray,   # [N, H, W]
    imgs_depth: jnp.ndarray,  # [N, H, W] float32 metric depth
    config: VOConfig,
):
    def body(s, frame):
        g, d = frame
        s2, pose, metrics = _track_frame_rgbd(s, g, d, config)
        return s2, (pose, metrics)

    state, (poses, metrics) = jax.lax.scan(body, state, (imgs_gray, imgs_depth))
    return state, poses, metrics


def _rectify_pair(img_left, img_right, map_left, map_right):
    """On-device stereo rectification (euroc_example.cpp:142-143's cv::remap
    fused into the step; the maps are static per sequence)."""
    from lvt_tpu.ops.undistort import remap_bilinear

    with jax.named_scope("rectify"):
        return (
            remap_bilinear(img_left.astype(jnp.float32), map_left),
            remap_bilinear(img_right.astype(jnp.float32), map_right),
        )


@functools.partial(jax.jit, static_argnames=("config",))
def track_step_stereo_rectified(
    state: VOState,
    img_left: jnp.ndarray, img_right: jnp.ndarray,     # raw (distorted)
    map_left: jnp.ndarray, map_right: jnp.ndarray,     # [H, W, 2] remaps
    config: VOConfig,
):
    """Rectification + extraction + tracking as ONE compiled program."""
    l, r = _rectify_pair(img_left, img_right, map_left, map_right)
    return _track_frame_stereo(state, l, r, config)


@functools.partial(jax.jit, static_argnames=("config",))
def track_chunk_stereo_rectified(
    state: VOState,
    imgs_left: jnp.ndarray,   # [N, H, W] raw
    imgs_right: jnp.ndarray,  # [N, H, W] raw
    map_left: jnp.ndarray, map_right: jnp.ndarray,
    config: VOConfig,
):
    """Chunked variant: remap happens inside the per-frame scan body, so a
    whole rectified-dataset chunk is still one device dispatch."""

    def body(s, frame):
        il, ir = frame
        l, r = _rectify_pair(il, ir, map_left, map_right)
        s2, pose, metrics = _track_frame_stereo(s, l, r, config)
        return s2, (pose, metrics)

    state, (poses, metrics) = jax.lax.scan(body, state, (imgs_left, imgs_right))
    return state, poses, metrics


@functools.partial(jax.jit, static_argnames=("config",))
def track_step_external_corners(
    state: VOState,
    img_left: jnp.ndarray, img_right: jnp.ndarray,
    corners_left: jnp.ndarray, corners_left_valid: jnp.ndarray,
    corners_right: jnp.ndarray, corners_right_valid: jnp.ndarray,
    config: VOConfig,
):
    """Descriptors-only path with caller-supplied corners
    (track_with_external_corners, lvt_system.cpp:209-250)."""
    left = extract.describe_external_corners(
        img_left, corners_left, corners_left_valid, config
    )
    right = extract.describe_external_corners(
        img_right, corners_right, corners_right_valid, config
    )
    return track_features(state, left, right, config, rgbd=False)
