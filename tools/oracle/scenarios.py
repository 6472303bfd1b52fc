"""Shared synthetic-world parity scenarios.

One definition used by both the golden generator (scripts/make_goldens.py,
which runs the reference oracle) and the regression test
(tests/test_parity_oracle.py, which runs lvt_tpu on the SAME frames and
compares ATE/RPE/rotation error against the stored oracle metrics). Frames
are deterministic: worlds are seeded and per-frame sensor noise uses a
fixed seed.

Two image models:
  * "blobs"    — isolated Gaussian splats (ideal features);
  * "textured" — ray-cast corridor with procedural noise texture
    (natural-imagery-like dense gradients), with low-texture, repetitive-
    structure, occlusion and illumination-drift stress variants — the
    regimes where detector/descriptor/matching choices actually diverge
    from the reference behavior.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterator

import numpy as np

from lvt_tpu.io.synthetic import SyntheticWorld, TexturedWorld


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    n_frames: int
    sensor: str = "stereo"       # "stereo" | "rgbd"
    speed: float = 0.8
    yaw_rate: float = 0.002
    noise_sigma: float = 0.0
    noise_seed: int = 1234
    # margins for the parity assertions: lvt_tpu metric must be
    # <= oracle metric * rel + abs (rel tightened 1.15 -> 1.10 in r4;
    # measured slack is 10-100x on most scenarios — scripts/ba_accuracy_
    # report.py prints the current ratios)
    rel_margin: float = 1.10
    abs_margin: float = 0.10       # ATE, meters
    rpe_abs_margin: float = 0.01   # RPE(1), meters
    rot_abs_margin: float = 0.25   # rotation RMSE, degrees
    kitti_geometry: bool = False   # full KITTI frame size + intrinsics
    world_kind: str = "blobs"      # "blobs" | "textured"
    world_args: tuple = ()         # ((field, value), ...) world overrides
    illum_drift: float = 0.0       # multiplicative exposure drift amplitude
    # (start, end) frame range rendered BLACK (sensor dropout): tracking
    # must go LOST and, with reset_on_lost, recover afterwards — the ROS
    # shell's auto-reset policy (lvt_ros.cpp:241-254) exercised end-to-end
    blackout: tuple = ()
    reset_on_lost: bool = False
    # ((field, value), ...) lvt_tpu VOConfig overrides for this scenario —
    # the oracle ignores them (it models the reference, which e.g. has no
    # windowed BA); used to measure beyond-parity features against the
    # same golden (tests/test_parity_oracle.py::_config)
    vo_overrides: tuple = ()

    def world(self):
        if self.world_kind == "textured":
            return TexturedWorld(**dict(self.world_args))
        if self.kitti_geometry:
            # KITTI seq 00 camera (lvt_tpu/configs/kitti/00.yaml)
            return SyntheticWorld(
                width=1241, height=376, fx=718.856, fy=718.856,
                cx=607.1928, cy=185.2157, baseline=0.5371657,
                n_points=6000, extent_x=80.0, extent_y=20.0,
                extent_z=160.0,
            )
        return SyntheticWorld(**dict(self.world_args))

    def frames(self) -> Iterator[tuple[np.ndarray, np.ndarray, tuple]]:
        """Yields (img1 uint8/float, img2, (gt_rotation, gt_position)).
        img2 is the right stereo image (uint8) or the float32 depth map
        for RGB-D."""
        world = self.world()
        rs = np.random.RandomState(self.noise_seed)
        if self.sensor == "stereo":
            seq = world.stereo_sequence(self.n_frames, speed=self.speed,
                                        yaw_rate=self.yaw_rate)
        else:
            seq = world.rgbd_sequence(self.n_frames, speed=self.speed,
                                      yaw_rate=self.yaw_rate)
        for i, (a, b, (r, t)) in enumerate(seq):
            if self.blackout and self.blackout[0] <= i <= self.blackout[1]:
                a = np.zeros_like(a)
                if self.sensor == "stereo":
                    b = np.zeros_like(b)
            if self.illum_drift > 0.0:
                # auto-exposure-like drift, ~40-frame period
                gain = 1.0 + self.illum_drift * np.sin(2 * np.pi * i / 40.0)
                a = a * gain
                if self.sensor == "stereo":
                    b = b * gain
            if self.noise_sigma > 0.0:
                a = a + rs.randn(*a.shape) * self.noise_sigma
                if self.sensor == "stereo":
                    b = b + rs.randn(*b.shape) * self.noise_sigma
            a = np.clip(a, 0, 255).astype(np.uint8)
            if self.sensor == "stereo":
                b = np.clip(b, 0, 255).astype(np.uint8)
            else:
                b = np.asarray(b, np.float32)
            yield a, b, (r, t)


def run_with_reset_on_lost(track, get_state, reset, frames, lost_state=3):
    """Drive a VO system (oracle or lvt_tpu) with the ROS shell's
    reset-on-lost + external odometry accumulation policy
    (lvt_ros.cpp:241-254 with m_reset_pose_on_lost_vo = false; identical to
    lvt_tpu.io.streaming.StreamingVO with identity extrinsic and no axis
    fix). ``track(a, b) -> (R [3,3], t [3])``. Returns
    (est_r, est_t, gt_r, gt_t, went_lost: bool)."""
    accum = np.eye(4)
    last = np.eye(4)
    est_r, est_t, gt_r, gt_t = [], [], [], []
    went_lost = False
    for a, b, (r, t) in frames:
        rot, pos = track(a, b)
        cur = np.eye(4)
        cur[:3, :3] = rot
        cur[:3, 3] = pos
        accum = accum @ (np.linalg.inv(last) @ cur)
        last = cur
        if get_state() == lost_state:
            went_lost = True
            reset()
            last = np.eye(4)
        est_r.append(accum[:3, :3].copy())
        est_t.append(accum[:3, 3].copy())
        gt_r.append(r)
        gt_t.append(t)
    return (np.array(est_r), np.array(est_t), np.array(gt_r),
            np.array(gt_t), went_lost)


SCENARIOS = (
    # ---- blob world (ideal isolated features)
    Scenario("fwd_yaw", n_frames=100),
    Scenario("turn", n_frames=80, speed=0.6, yaw_rate=0.02),
    Scenario("noisy", n_frames=80, noise_sigma=4.0),
    Scenario("fast", n_frames=60, speed=1.6),
    Scenario("rgbd", n_frames=80, sensor="rgbd", speed=0.5),
    # the benchmark's exact camera: full KITTI frame size + seq-00 intrinsics
    Scenario("kitti_geom", n_frames=40, speed=0.9, kitti_geometry=True),
    # ---- textured world (natural-imagery-like dense texture)
    Scenario("textured", n_frames=80, world_kind="textured"),
    Scenario("tex_lowtex", n_frames=60, world_kind="textured",
             world_args=(("texture_amp", 45.0),)),
    # periodic structure once needed a wider margin (r4: plateau-collapsed
    # NMS clustered equal-score picks, RPE 1.23x oracle); the r5 van der
    # Corput plateau-spreading tie-break (ops/detect._plateau_dither)
    # brought it back inside the standard margin (measured RPE 1.10x,
    # ATE 0.47x, rot 0.53x oracle)
    Scenario("tex_stripes", n_frames=60, world_kind="textured",
             world_args=(("stripe_walls", True),)),
    Scenario("tex_occlusion", n_frames=70, world_kind="textured",
             world_args=(("n_occluders", 4),)),
    Scenario("tex_illum", n_frames=60, world_kind="textured",
             illum_drift=0.18),
    Scenario("tex_rgbd", n_frames=60, sensor="rgbd", speed=0.5,
             world_kind="textured"),
    # ---- failure/recovery: 5-frame sensor blackout mid-run; both systems
    # must go LOST, auto-reset, re-initialize and keep tracking. The gt
    # motion during the blackout is unobservable, so both carry the same
    # constant offset afterwards; parity margins absorb the common loss.
    Scenario("lost_recovery", n_frames=60, speed=0.6, blackout=(25, 29),
             reset_on_lost=True),
    # ---- windowed BA enabled in the INTEGRATED pipeline: same frames as
    # "noisy"; the oracle golden is BA-less (the reference never refines
    # structure), so this pins the accuracy of the
    # beyond-parity feature against the same bar, and
    # scripts/ba_accuracy_report.py quantifies the delta vs BA-off
    Scenario("noisy_ba", n_frames=80, noise_sigma=4.0,
             vo_overrides=(("local_ba_window", 4),)),
)


GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"


def lvt_config(sc: Scenario):
    """The lvt_tpu VOConfig a scenario runs: its world's camera plus the
    scenario's vo_overrides."""
    from lvt_tpu.config import VOConfig

    world = sc.world()
    return VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, **dict(sc.vo_overrides),
    )


def run_lvt(sc: Scenario, frames=None):
    """Track a scenario's frames (default: ``sc.frames()``) through
    lvt_tpu's VOSystem, one ``track`` call per frame. Returns
    (est_t, est_r, gt_t, gt_r) arrays. Reset-on-lost scenarios must go LOST
    and end TRACKING (AssertionError otherwise)."""
    from lvt_tpu.core.system import SensorType, TrackingState, VOSystem
    from lvt_tpu.geometry import quaternion as quat

    frames = sc.frames() if frames is None else frames
    sensor = SensorType.RGBD if sc.sensor == "rgbd" else SensorType.STEREO
    vo = VOSystem(lvt_config(sc), sensor)

    def track(a, b):
        pose = vo.track(a, b)
        return np.asarray(quat.to_matrix(pose.q)), np.asarray(pose.t)

    if sc.reset_on_lost:
        est_r, est, gt_r, gt, went_lost = run_with_reset_on_lost(
            track, vo.get_state, vo.reset, frames,
            lost_state=TrackingState.LOST,
        )
        assert went_lost, "blackout never caused LOST"
        assert vo.get_state() == TrackingState.TRACKING, "did not recover"
        return est, est_r, gt, gt_r
    est, est_r, gt, gt_r = [], [], [], []
    for a, b, (r, t) in frames:
        rot, pos = track(a, b)
        est.append(pos)
        est_r.append(rot)
        gt.append(t)
        gt_r.append(r)
    return np.array(est), np.array(est_r), np.array(gt), np.array(gt_r)


def parity_rows(sc: Scenario, est, est_r, gt, gt_r):
    """The three parity axes against the stored oracle run on identical
    frames: absolute trajectory error, 1-frame relative pose error (local
    drift) and rotation RMSE, each bounded by oracle * rel_margin + abs.
    Returns [(axis, ours, bound, oracle, unit)]."""
    from lvt_tpu.io.synthetic import ate_rmse
    from lvt_tpu.io.trajectory import rot_rmse_deg, rpe_rmse

    golden_path = GOLDEN_DIR / f"{sc.name}.npz"
    assert golden_path.exists(), (
        f"golden fixture missing; run scripts/make_goldens.py {sc.name}"
    )
    golden = np.load(golden_path)
    assert int(golden["n_frames"]) == sc.n_frames, "fixture out of date"
    rows = []
    for axis, ours, key, abs_m, unit in (
        ("ATE", ate_rmse(est, gt), "ate", sc.abs_margin, "m"),
        ("RPE(1)", rpe_rmse(est, gt), "rpe", sc.rpe_abs_margin, "m"),
        ("rot", rot_rmse_deg(np.array(est_r), np.array(gt_r)), "rot",
         sc.rot_abs_margin, "deg"),
    ):
        oracle = float(golden[key])
        rows.append((axis, ours, oracle * sc.rel_margin + abs_m, oracle,
                     unit))
    return rows


def by_name(name: str) -> Scenario:
    for s in SCENARIOS:
        if s.name == name:
            return s
    raise KeyError(name)
