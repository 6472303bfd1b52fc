"""Measure the reference-oracle pipeline's CPU throughput (the baseline
denominator for bench.py / BASELINE.md).

Mirrors the reference's timing bracket: kitti_example.cpp:129-131 measures
only the vo->track() call on KITTI stereo frames. Here the frames are
KITTI-geometry synthetic stereo renders (no dataset in this environment);
the oracle runs the identical reference pipeline (grid FAST + ANMS + BRIEF +
hash-grid masked 2-NN matching + LM PnP + map maintenance).

Usage: python scripts/bench_oracle.py [n_frames]
Prints one JSON line with fps + per-stage notes.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse
from tools.oracle.system import OracleVO, OracleParams


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    # KITTI seq 00 geometry (lvt_tpu/configs/kitti/00.yaml)
    width, height = 1241, 376
    fx = fy = 718.856
    cx, cy = 607.1928, 185.2157
    baseline = 0.5371657

    world = SyntheticWorld(
        width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy,
        baseline=baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    frames = [
        (l.astype(np.uint8), r.astype(np.uint8), t)
        for l, r, (_, t) in world.stereo_sequence(n_frames, speed=0.9)
    ]

    params = OracleParams(fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline,
                          img_width=width, img_height=height)
    vo = OracleVO(params)
    vo.track(frames[0][0], frames[0][1])  # init frame outside timed region

    est, gt = [], []
    t0 = time.perf_counter()
    for l, r, t in frames[1:]:
        pose = vo.track(l, r)
        est.append(pose[1])
        gt.append(t)
    dt = time.perf_counter() - t0
    fps = (n_frames - 1) / dt
    print(json.dumps({
        "metric": "oracle frames/s (KITTI-geometry stereo, synthetic world)",
        "value": round(fps, 3),
        "unit": "frames/s",
        "n_frames": n_frames,
        "ate": round(ate_rmse(np.array(est), np.array(gt)), 4),
        "final_state": int(vo.get_state()),
    }))


if __name__ == "__main__":
    main()
