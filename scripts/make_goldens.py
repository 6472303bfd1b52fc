"""Generate golden oracle trajectories for the parity regression tests.

Runs the faithful reference oracle (tools/oracle) over every scenario in
tools/oracle/scenarios.py and stores its trajectory + the ground truth +
its ATE as tests/golden/<name>.npz. tests/test_parity_oracle.py then runs
lvt_tpu over the SAME frames and asserts its ATE is within margin of the
stored oracle ATE — the trajectory-level acceptance bar of SURVEY.md §4.

Usage: python scripts/make_goldens.py [scenario ...]
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lvt_tpu.io.synthetic import ate_rmse
from lvt_tpu.io.trajectory import rot_rmse_deg, rpe_rmse
from tools.oracle.system import OracleVO, OracleParams
from tools.oracle.scenarios import SCENARIOS, by_name

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden"


def run_scenario(sc) -> dict:
    world = sc.world()
    params = OracleParams(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height,
    )
    vo = OracleVO(params, sensor=sc.sensor)
    t0 = time.perf_counter()
    if sc.reset_on_lost:
        from tools.oracle.scenarios import run_with_reset_on_lost
        from tools.oracle.system import LOST

        est_r, est, gt_r, gt, went_lost = run_with_reset_on_lost(
            lambda a, b: vo.track(a, b), vo.get_state, vo.reset,
            sc.frames(), lost_state=LOST,
        )
        assert went_lost, f"{sc.name}: blackout never caused LOST"
    else:
        est, est_r, gt, gt_r = [], [], [], []
        for a, b, (r, t) in sc.frames():
            pose = vo.track(a, b)
            est.append(pose[1])
            est_r.append(pose[0])
            gt.append(t)
            gt_r.append(r)
        est = np.array(est)
        est_r = np.array(est_r)
        gt = np.array(gt)
        gt_r = np.array(gt_r)
    dt = time.perf_counter() - t0
    return {
        "est_t": est,
        "est_r": est_r,
        "gt_t": gt,
        "gt_r": gt_r,
        "ate": np.float64(ate_rmse(est, gt)),
        "rpe": np.float64(rpe_rmse(est, gt)),
        "rot": np.float64(rot_rmse_deg(est_r, gt_r)),
        "fps": np.float64(len(gt) / dt),
        "final_state": np.int32(vo.get_state()),
        "n_frames": np.int32(sc.n_frames),
    }


def main():
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    names = sys.argv[1:] or [s.name for s in SCENARIOS]
    for name in names:
        sc = by_name(name)
        print(f"== {name} ({sc.n_frames} frames, {sc.sensor}) ...",
              flush=True)
        res = run_scenario(sc)
        out = GOLDEN_DIR / f"{name}.npz"
        np.savez_compressed(out, **res)
        print(f"   ATE {float(res['ate']):.4f} m  RPE {float(res['rpe']):.4f} m"
              f"  rot {float(res['rot']):.3f} deg  "
              f"{float(res['fps']):.2f} fps  state={int(res['final_state'])}"
              f"  -> {out}")


if __name__ == "__main__":
    main()
