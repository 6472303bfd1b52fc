"""CPU rehearsal of chip_smoke.py: its device check, and its one-card
phase functions on tiny worlds (the script itself runs them at full size
on a GPU)."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from lvt_tpu.config import VOConfig
from lvt_tpu.core.system import SensorType, VOSystem
from lvt_tpu.ops.undistort import make_rectify_map

WORLD = dict(width=160, height=96, fx=120.0, fy=120.0, cx=80.0, cy=48.0,
             baseline=0.3, n_points=600, extent_x=25.0, extent_y=10.0,
             extent_z=50.0, seed=7)
N_ONLINE, CHUNK = 3, 2
N = N_ONLINE + 2 * CHUNK


def log(msg):
    print(msg)


def tiny_config(**kw):
    base = dict(
        fx=WORLD["fx"], fy=WORLD["fy"], cx=WORLD["cx"], cy=WORLD["cy"],
        baseline=WORLD["baseline"], img_width=WORLD["width"],
        img_height=WORLD["height"], detection_cell_size=80,
        max_keypoints_per_cell=40, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=90.0,
        max_map_points=256, max_staged_points=256)
    return VOConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def kitti_like():
    """The phase-1 path (stereo, BA-4, uint8 frames) on a tiny world."""
    cfg = tiny_config(local_ba_window=4, local_ba_every=2)
    frames = cs.render(("stereo", WORLD, N, 0.3, None, False))
    ate, diff, vo = cs.run_single(log, "tiny stereo", lambda: VOSystem(cfg),
                                  frames, N_ONLINE, CHUNK, ate_bound=0.5)
    return cfg, frames, vo, ate, diff


def test_refuses_to_run_without_a_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_shipped_configs_load():
    kitti, euroc, tum = cs.kitti_config(), cs.euroc_config(), cs.tum_config()
    assert (kitti.kp_capacity, kitti.max_map_points,
            kitti.local_ba_window) == (1536, 1024, 4)
    assert (euroc.img_width, euroc.img_height,
            euroc.max_map_points) == (752, 480, 4096)
    assert tum.max_map_points == 8192 and abs(tum.k1) > 1e-5


def test_stereo_online_and_chunked(kitti_like):
    _, frames, vo, ate, diff = kitti_like
    assert frames[0][0].dtype == np.uint8
    assert ate < 0.5 and diff <= cs.POSE_TOL_M
    assert vo.frame_number == N


def test_rectified_stereo_through_raw_cameras():
    """Phase 2's path: raw distorted frames, remapped inside the step."""
    k = np.array([[WORLD["fx"], 0, WORLD["cx"]], [0, WORLD["fy"],
                  WORLD["cy"]], [0, 0, 1.0]])
    dist = np.array([-0.05, 0.01, 0.0, 0.0, 0.0])
    c, s = np.cos(0.01), np.sin(0.01)
    r_rect = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    w, h = WORLD["width"], WORLD["height"]
    maps = tuple(make_rectify_map(w, h, k, dist, r_rect, k) for _ in "lr")
    frames = cs.render(("stereo", WORLD, N, 0.3,
                        ((k, dist, r_rect), (k, dist, r_rect)), False))
    cfg = tiny_config()
    ate, diff, _ = cs.run_single(
        log, "tiny rectified", lambda: VOSystem(cfg, rectify_maps=maps),
        frames, N_ONLINE, CHUNK, ate_bound=0.5)
    assert diff <= cs.POSE_TOL_M


def test_rgbd_with_distortion():
    """Phase 3's path: distorted image, registered depth, k1 != 0."""
    world = dict(WORLD, extent_x=2.5, extent_y=1.2, extent_z=5.0,
                 n_points=300)
    cfg = tiny_config(k1=0.1, k2=-0.05, near_plane_distance=0.1,
                      far_plane_distance=5.0)
    k = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames = cs.render(("rgbd", world, N, 0.02,
                        (k, (cfg.k1, cfg.k2, 0.0, 0.0, 0.0), np.eye(3)),
                        False))
    assert frames[0][1].dtype == np.float32 and frames[0][1].max() > 0
    cs.run_single(log, "tiny rgbd", lambda: VOSystem(cfg, SensorType.RGBD),
                  frames, N_ONLINE, CHUNK, ate_bound=0.5)


def test_multistream_matches_single_streams(kitti_like):
    cfg = kitti_like[0]
    streams = [cs.render(("stereo", dict(WORLD, seed=101 + k), 2 * CHUNK,
                          0.3 + 0.05 * k, None, False)) for k in range(2)]
    assert cs.run_multistream(log, cfg, streams, CHUNK) <= cs.POSE_TOL_M


def test_determinism(kitti_like):
    _, frames, vo, _, _ = kitti_like
    state = vo.state
    assert cs.run_determinism(log, vo, frames[-CHUNK:]) == 0.0
    vo.state = state


def test_hamming_exactness():
    cs.run_hamming_exactness(log, 40, 56)


def test_hamming_ab(kitti_like):
    cfg, frames, _, _, _ = kitti_like
    med = cs.time_hamming_ab(log, cfg, frames[:CHUNK],
                             frames[CHUNK:2 * CHUNK], rounds=1)
    assert set(med) == {False, True} and min(med.values()) > 0


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")
