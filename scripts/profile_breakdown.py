"""Marginal-cost breakdown of track_step_stereo via cumulative jits.

Times progressively larger prefixes of the tracking pipeline on a realistic
(populated) VOState, so each stage's marginal cost includes real fusion
effects. Perf tool, not a test.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=30, warmup=3):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    from lvt_tpu import runtime

    runtime.require_gpu()   # times the device; never the CPU
    import __graft_entry__ as ge
    from lvt_tpu.core import extract as ex, step as step_mod
    from lvt_tpu.core.state import VOState
    from lvt_tpu.core.motion import predict_next_pose
    from lvt_tpu.ops import matching, hamming, triangulate
    from lvt_tpu.solver.pnp import solve_pnp
    from lvt_tpu.io.synthetic import SyntheticWorld

    config = ge._kitti_config()
    world = SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    frames = list(world.stereo_sequence(12, speed=0.9))
    il = jnp.asarray(np.stack([f[0] for f in frames]), jnp.float32)
    ir = jnp.asarray(np.stack([f[1] for f in frames]), jnp.float32)

    # populate a realistic state by tracking 10 frames
    state = VOState.initial(config.max_map_points, config.max_staged_points,
                            config.local_ba_window)
    step = jax.jit(lambda s, a, b: step_mod.track_step_stereo(s, a, b, config))
    for i in range(10):
        state, _, _ = step(state, il[i], ir[i])
    jax.block_until_ready(state.pose.t)
    print(f"backend={jax.default_backend()} map={int(state.map.size())} "
          f"staged={int(state.staged.size())} kp_cap={config.kp_capacity}")

    a, b = il[10], ir[10]
    cam = step_mod._camera_kwargs(config)

    feats = jax.jit(lambda a, b: ex.extract_features_stereo(a, b, config))(a, b)
    jax.block_until_ready(feats[0].kp)

    # stage jits on materialized inputs
    def j(fn):
        return jax.jit(fn)

    t_extract = timeit(
        j(lambda a, b: ex.extract_features_stereo(a, b, config)), a, b)

    left, right = feats

    def mm_fn(st, left):
        _, predicted = predict_next_pose(st.motion, st.pose)
        return matching.find_map_matches(
            st.map.pos, st.map.desc, st.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, **cam)

    t_mm = timeit(j(mm_fn), state, left)
    mm = j(mm_fn)(state, left)
    jax.block_until_ready(mm.match_idx)

    k = left.kp.shape[0]

    def pnp_fn(st, left, mi):
        _, predicted = predict_next_pose(st.motion, st.pose)
        obs = left.kp[jnp.clip(mi, 0, k - 1)]
        w = (mi >= 0).astype(jnp.float32)
        return solve_pnp(predicted, st.map.pos, obs, w,
                         fx=config.fx, fy=config.fy, cx=config.cx,
                         cy=config.cy,
                         reprojection_th2=config.reprojection_th2)

    t_pnp = timeit(j(pnp_fn), state, left, mm.match_idx)

    def rm_fn(left, right, fm):
        return matching.row_match(
            left, right, fm,
            vertical_search_radius=config.row_matching_vertical_search_radius,
            ratio_threshold=config.triangulation_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            img_rows=config.img_height)

    t_rm = timeit(j(rm_fn), left, right, mm.feature_matched)

    def staged_fn(st, left, fm):
        return step_mod._staged_update(
            st.staged, st.pose, left, fm, st.map.size(), config)

    t_staged = timeit(j(staged_fn), state, left, mm.feature_matched)

    def tri_fn(st, left, right, fm):
        return step_mod._triangulate_new_points(
            left, right, fm, st.pose, config, False)

    t_tri = timeit(j(tri_fn), state, left, right, mm.feature_matched)

    def track_only(st, left, right):
        return step_mod._track_branch(st, left, right, config, False)

    t_track_branch = timeit(j(track_only), state, left, right)
    t_full = timeit(step, state, a, b)

    print(f"extract_stereo:        {t_extract:7.3f} ms")
    print(f"find_map_matches:      {t_mm:7.3f} ms")
    print(f"solve_pnp:             {t_pnp:7.3f} ms")
    print(f"row_match:             {t_rm:7.3f} ms")
    print(f"staged_update:         {t_staged:7.3f} ms")
    print(f"triangulate_new:       {t_tri:7.3f} ms  (includes row_match)")
    print(f"_track_branch (all):   {t_track_branch:7.3f} ms")
    print(f"full step:             {t_full:7.3f} ms")


if __name__ == "__main__":
    main()
