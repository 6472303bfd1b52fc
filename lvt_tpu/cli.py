"""Command-line drivers — equivalents of the reference's three example
binaries (examples/kitti, examples/euroc, examples/tum_rgbd) plus a
dataset-free synthetic run and the benchmark.

    python -m lvt_tpu kitti --sequences-dir D --seq 0 [--output 00.txt]
    python -m lvt_tpu euroc --root D --dataset MH_01_easy [--output MH_01.txt]
    python -m lvt_tpu tum   --dataset-dir D [--freiburg 1] [--output out.txt]
    python -m lvt_tpu synthetic [--frames 60]
    python -m lvt_tpu bench

Trajectories are written in the same formats the reference emits (KITTI 3x4
rows / TUM timestamped quaternions) so the standard evaluators (KITTI devkit,
evo, TUM scripts) consume them unchanged.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def _progress(i, n, t0):
    dt = time.perf_counter() - t0
    fps = (i + 1) / dt if dt > 0 else 0.0
    sys.stdout.write(f"\rframe {i + 1}/{n}  ({fps:.1f} fps)")
    sys.stdout.flush()


def run_kitti(args) -> int:
    from lvt_tpu.config import load_config
    from lvt_tpu.core.system import TrackingState, VOSystem
    from lvt_tpu.io.datasets import KittiSequence
    from lvt_tpu.io.trajectory import dump_kitti
    from lvt_tpu.observability import ValueRecorder

    seq = KittiSequence(args.sequences_dir, args.seq, args.calib)
    cfg_path = args.config or os.path.join(CONFIG_DIR, "kitti", "vo_config.yaml")
    config = seq.configure(load_config(cfg_path))
    recorder = ValueRecorder() if args.record else None
    vo = VOSystem(config, metrics_recorder=recorder)

    viz = _make_viz(args)
    poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    out = args.output or f"{args.seq:02d}.txt"
    dump_kitti(out, poses)
    print(f"trajectory written to {out}")
    if recorder:
        recorder.finish()
    return 0


def _make_viz(args):
    if not getattr(args, "viz", None):
        return None
    from lvt_tpu.viz_html import HtmlMapViewer

    return HtmlMapViewer(args.viz)


def _finish_viz(viz):
    if viz is not None:
        print(f"viewer written to {viz.write_viewer()}")


def _track_sequence(vo, seq, chunk: int, viz=None):
    """Shared per-frame / chunked tracking loop. Returns the pose list
    (stops on LOST like the reference drivers, kitti_example.cpp:133-137).
    Chunk mode streams: only `chunk` decoded frames are in host memory at a
    time (a full EuRoC sequence would be ~2.5 GB if materialized)."""
    import itertools

    import jax

    from lvt_tpu.core.system import TrackingState

    n = len(seq)
    poses = []
    t0 = time.perf_counter()
    if chunk > 1:
        it = iter(seq)
        done = 0
        while True:
            block = list(itertools.islice(it, chunk))
            if not block:
                break
            a = np.stack([f[0] for f in block])
            b = np.stack([f[1] for f in block])
            chunk_poses, chunk_metrics = vo.track_chunk(a, b)
            # truncate at the first LOST frame inside the chunk so frozen
            # post-LOST poses never reach the trajectory file (the reference
            # drivers stop the sequence at LOST, kitti_example.cpp:133-137)
            status = np.asarray(chunk_metrics.status)
            lost_at = np.nonzero(status == int(TrackingState.LOST))[0]
            keep = int(lost_at[0]) + 1 if lost_at.size else len(block)
            for i in range(keep):
                poses.append(jax.tree.map(lambda x: x[i], chunk_poses))
            done += keep
            if viz is not None:
                viz.update(vo)  # one snapshot per chunk in chunked mode
            _progress(done - 1, n, t0)
            if lost_at.size:
                break
    else:
        for i, (a, b) in enumerate(seq):
            poses.append(vo.track(a, b))
            if viz is not None:
                viz.update(vo)
            _progress(i, n, t0)
            if vo.get_state() == TrackingState.LOST:
                break
    total = time.perf_counter() - t0
    print(f"\nAverage frame processing time: {total / max(len(poses), 1):.4f}s")
    return poses


def run_euroc(args) -> int:
    from lvt_tpu.config import load_config
    from lvt_tpu.core.system import VOSystem
    from lvt_tpu.geometry.se3 import Pose
    from lvt_tpu.io.datasets import EUROC_T_BS, EurocSequence
    from lvt_tpu.io.trajectory import dump_tum
    from lvt_tpu.observability import ValueRecorder

    seq = EurocSequence(args.root, args.dataset, args.stamps)
    cfg_path = args.config or os.path.join(CONFIG_DIR, "euroc", "vo_config.yaml")
    config = seq.configure(load_config(cfg_path))
    recorder = ValueRecorder() if args.record else None
    # rectification remap runs INSIDE the jitted step (raw frames in)
    vo = VOSystem(config, metrics_recorder=recorder,
                  rectify_maps=(seq.map_l, seq.map_r))

    import jax.numpy as jnp

    viz = _make_viz(args)
    cam_poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    # express in the body frame: T_BS * T_cam (euroc_example.cpp:153-158)
    poses = [
        Pose.from_matrix44(jnp.asarray(
            EUROC_T_BS @ np.asarray(p.matrix44()), jnp.float32))
        for p in cam_poses
    ]
    out = args.output or f"{args.dataset}.txt"
    dump_tum(out, poses, seq.stamps[: len(poses)])
    print(f"trajectory written to {out}")
    if recorder:
        recorder.finish()
    return 0


def run_tum(args) -> int:
    from lvt_tpu.config import load_config
    from lvt_tpu.core.system import SensorType, VOSystem
    from lvt_tpu.io.datasets import TumRgbdSequence
    from lvt_tpu.io.trajectory import dump_tum
    from lvt_tpu.observability import ValueRecorder

    seq = TumRgbdSequence(args.dataset_dir, args.association)
    cfg_path = args.config or os.path.join(
        CONFIG_DIR, "tum_rgbd", f"config_tum{args.freiburg}.yaml"
    )
    config = load_config(cfg_path)
    recorder = ValueRecorder() if args.record else None
    vo = VOSystem(config, SensorType.RGBD, metrics_recorder=recorder)

    viz = _make_viz(args)
    poses = _track_sequence(vo, seq, args.chunk, viz)
    _finish_viz(viz)
    out = args.output or "tum_trajectory.txt"
    dump_tum(out, poses, seq.stamps[: len(poses)])
    print(f"trajectory written to {out}")
    if recorder:
        recorder.finish()
    return 0


def run_synthetic(args) -> int:
    from lvt_tpu.config import VOConfig
    from lvt_tpu.core.system import VOSystem
    from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse

    world = SyntheticWorld()
    config = VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=160,
        max_keypoints_per_cell=100, agast_threshold=15,
        near_plane_distance=0.5, far_plane_distance=200.0,
    )
    vo = VOSystem(config)
    viz = _make_viz(args)
    est, gt = [], []
    t0 = time.perf_counter()
    for i, (img_l, img_r, (r, t)) in enumerate(
        world.stereo_sequence(args.frames, speed=0.8)
    ):
        pose = vo.track(img_l, img_r)
        est.append(np.asarray(pose.t))
        gt.append(t)
        if viz is not None:
            viz.update(vo)
        _progress(i, args.frames, t0)
    _finish_viz(viz)
    err = ate_rmse(np.array(est), np.array(gt))
    dist = float(np.linalg.norm(gt[-1] - gt[0]))
    print(f"\nATE RMSE: {err:.3f} m over {dist:.1f} m trajectory "
          f"({100 * err / dist:.2f}%)")
    return 0


def run_bench(args) -> int:
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lvt-tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="run a KITTI odometry sequence")
    k.add_argument("--sequences-dir", required=True)
    k.add_argument("--seq", type=int, required=True)
    k.add_argument("--calib", default=None)
    k.add_argument("--config", default=None)
    k.add_argument("--output", default=None)
    k.add_argument("--chunk", type=int, default=16,
                   help="frames per device dispatch (1 = online mode)")
    k.add_argument("--record", action="store_true",
                   help="write per-frame metrics CSV (measurments.txt)")
    k.add_argument("--viz", default=None, metavar="DIR",
                   help="write a browsable 3-D map viewer (viewer.html)")
    k.set_defaults(fn=run_kitti)

    e = sub.add_parser("euroc", help="run a EuRoC MAV sequence")
    e.add_argument("--root", required=True)
    e.add_argument("--dataset", required=True)
    e.add_argument("--stamps", default=None)
    e.add_argument("--config", default=None)
    e.add_argument("--output", default=None)
    e.add_argument("--chunk", type=int, default=16,
                   help="frames per device dispatch (1 = online mode)")
    e.add_argument("--record", action="store_true",
                   help="write per-frame metrics CSV (measurments.txt)")
    e.add_argument("--viz", default=None, metavar="DIR",
                   help="write a browsable 3-D map viewer (viewer.html)")
    e.set_defaults(fn=run_euroc)

    t = sub.add_parser("tum", help="run a TUM RGB-D sequence")
    t.add_argument("--dataset-dir", required=True)
    t.add_argument("--association", default=None)
    t.add_argument("--freiburg", type=int, default=1, choices=(1, 2, 3))
    t.add_argument("--config", default=None)
    t.add_argument("--output", default=None)
    t.add_argument("--chunk", type=int, default=16,
                   help="frames per device dispatch (1 = online mode)")
    t.add_argument("--record", action="store_true",
                   help="write per-frame metrics CSV (measurments.txt)")
    t.add_argument("--viz", default=None, metavar="DIR",
                   help="write a browsable 3-D map viewer (viewer.html)")
    t.set_defaults(fn=run_tum)

    s = sub.add_parser("synthetic", help="dataset-free synthetic-world run")
    s.add_argument("--frames", type=int, default=60)
    s.add_argument("--viz", default=None, metavar="DIR",
                   help="write a browsable 3-D map viewer (viewer.html)")
    s.set_defaults(fn=run_synthetic)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.set_defaults(fn=run_bench)

    args = p.parse_args(argv)
    from lvt_tpu import runtime

    runtime.enable_compile_cache()
    dev = runtime.device_summary()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
