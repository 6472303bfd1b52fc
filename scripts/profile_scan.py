"""In-scan marginal cost of each pipeline stage (chunked mode).

Times lax.scan over a 16-frame chunk where the scanned body is a
progressively larger prefix of the tracking pipeline. The difference
between consecutive rows is that stage's real cost inside the production
dispatch (one dispatch per chunk, real fusion). Perf tool.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 16


def _anchor(out):
    np.asarray(jax.tree_util.tree_leaves(out)[-1])


def timeit(fn, *args, n=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _anchor(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _anchor(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    from lvt_tpu import runtime

    runtime.require_gpu()   # times the device; never the CPU
    import __graft_entry__ as ge
    from lvt_tpu.core import extract as ex, step as step_mod, map as map_ops
    from lvt_tpu.core.motion import predict_next_pose
    from lvt_tpu.core.state import VOState
    from lvt_tpu.ops import matching
    from lvt_tpu.solver.pnp import solve_pnp
    from lvt_tpu.io.synthetic import SyntheticWorld

    config = ge._kitti_config()
    cam = step_mod._camera_kwargs(config)
    world = SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    frames = list(world.stereo_sequence(CHUNK + 10, speed=0.9))
    # uint8 like the production path (kernel A takes the uint8 DMA route)
    il = jnp.asarray(np.stack([f[0].astype(np.uint8) for f in frames]))
    ir = jnp.asarray(np.stack([f[1].astype(np.uint8) for f in frames]))

    state = VOState.initial(config.max_map_points, config.max_staged_points,
                            config.local_ba_window)
    step = jax.jit(lambda s, a, b: step_mod.track_step_stereo(s, a, b, config))
    for i in range(10):
        state, _, _ = step(state, il[i], ir[i])
    np.asarray(state.pose.t)  # fence + warm the D2H channel
    print(f"backend={jax.default_backend()} map={int(state.map.size())}",
          flush=True)

    ca, cb = il[10:10 + CHUNK], ir[10:10 + CHUNK]
    k = config.kp_capacity

    def scan_over(body):
        @jax.jit
        def run(state, ca, cb):
            def f(s, ab):
                return body(s, ab[0], ab[1])
            return jax.lax.scan(f, state, (ca, cb))
        return run

    # 0: extraction only
    def body0(s, a, b):
        left, right = ex.extract_features_stereo(a, b, config)
        return s, (left.kp.sum() + right.kp.sum())

    # production backend flags (the full step derives these from config)
    flags = dict(use_kernel=step_mod._use_matching_kernel(config),
                 matmul=step_mod._hamming_matmul(config))

    # 1: + map matching (incl. motion prediction)
    def body1(s, a, b):
        left, right = ex.extract_features_stereo(a, b, config)
        _, predicted = predict_next_pose(s.motion, s.pose)
        mm = matching.find_map_matches(
            s.map.pos, s.map.desc, s.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, **flags, **cam)
        return s, mm.matches_count

    # 2: + PnP
    def body2(s, a, b):
        left, right = ex.extract_features_stereo(a, b, config)
        _, predicted = predict_next_pose(s.motion, s.pose)
        mm = matching.find_map_matches(
            s.map.pos, s.map.desc, s.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, **flags, **cam)
        obs = left.kp[jnp.clip(mm.match_idx, 0, k - 1)]
        w = (mm.match_idx >= 0).astype(jnp.float32)
        pnp = solve_pnp(predicted, s.map.pos, obs, w,
                        fx=config.fx, fy=config.fy, cx=config.cx,
                        cy=config.cy,
                        reprojection_th2=config.reprojection_th2)
        return s, pnp.inlier_count

    # 3: + staged + cleanup (bookkeeping)
    def body3(s, a, b):
        left, right = ex.extract_features_stereo(a, b, config)
        _, predicted = predict_next_pose(s.motion, s.pose)
        mm = matching.find_map_matches(
            s.map.pos, s.map.desc, s.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, **flags, **cam)
        obs = left.kp[jnp.clip(mm.match_idx, 0, k - 1)]
        w = (mm.match_idx >= 0).astype(jnp.float32)
        pnp = solve_pnp(predicted, s.map.pos, obs, w,
                        fx=config.fx, fy=config.fy, cx=config.cx,
                        cy=config.cy,
                        reprojection_th2=config.reprojection_th2)
        mb = map_ops.apply_match_bookkeeping(s.map, mm.match_idx)
        mc, fm = map_ops.clean_untracked(mb, mm.match_idx,
                                         mm.feature_matched,
                                         config.untracked_threshold)
        st, promo, fm = step_mod._staged_update(
            s.staged, pnp.pose, left, fm, mc.size(), config)
        return s._replace(map=mc, staged=st), fm.sum()

    # 4: full track branch via the real step
    def body4(s, a, b):
        s2, pose, _ = step_mod._track_frame_stereo(s, a, b, config)
        return s2, pose.t

    rows = [
        ("extract only", body0),
        ("+ map match", body1),
        ("+ pnp", body2),
        ("+ bookkeeping/staged", body3),
        ("full step", body4),
    ]
    # --row N times a single prefix
    import sys

    sel = None
    if "--row" in sys.argv:
        sel = int(sys.argv[sys.argv.index("--row") + 1])
    prev = 0.0
    for idx, (name, body) in enumerate(rows):
        if sel is not None and idx != sel:
            continue
        ms = timeit(scan_over(body), state, ca, cb)
        per = ms / CHUNK
        print(f"{name:24s} {ms:8.2f} ms/chunk  {per:6.3f} ms/fr  "
              f"(marginal {per - prev:+6.3f})", flush=True)
        prev = per


if __name__ == "__main__":
    main()
