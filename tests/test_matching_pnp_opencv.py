"""De-circularized checks vs OpenCV for matching and PnP.

The oracle (tools/oracle) shares our BRIEF pattern and acceptance rules, so
oracle-parity alone cannot catch a bug present in both. These tests anchor
two more stages to an INDEPENDENT implementation, like
tests/test_detector_opencv.py did for the detector in r4:

  * masked 2-NN Hamming matching vs cv2.BFMatcher(NORM_HAMMING).knnMatch
    with an explicit candidate mask (the reference's matcher backend,
    lvt/src/lvt_image_features_struct.cpp:104-120);
  * robust LM PnP vs cv2.solvePnPRansac + LM refinement on a synthetic
    scene with outliers (the reference's g2o solve,
    lvt/src/lvt_pnp_solver.cpp:60-128).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.ops import hamming
from lvt_tpu.solver.pnp import solve_pnp


@pytest.fixture
def rng():
    return np.random.RandomState(11)


# ---------------------------------------------------------------- matching
def _to_cv_desc(packed: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 32] uint8 rows for cv2 NORM_HAMMING (bit order
    within the descriptor does not matter for Hamming distances as long as
    both operands use the same packing)."""
    return packed.view(np.uint8).reshape(packed.shape[0], -1)


def test_masked_2nn_matches_bfmatcher(rng):
    q_n, t_n = 96, 128
    qd = rng.randint(0, 2 ** 32, (q_n, 8), dtype=np.uint64).astype(np.uint32)
    td = rng.randint(0, 2 ** 32, (t_n, 8), dtype=np.uint64).astype(np.uint32)
    # make some targets near-copies of queries so realistic best matches exist
    for i in range(0, q_n, 3):
        j = rng.randint(t_n)
        td[j] = qd[i]
        td[j, 0] ^= np.uint32(1 << rng.randint(32))  # hamming distance 1
    mask = (rng.rand(q_n, t_n) < 0.4).astype(np.uint8)

    d = hamming.hamming_matrix(jnp.asarray(qd), jnp.asarray(td))
    d1, d2, best, n_cand = hamming.masked_top2(d, jnp.asarray(mask) > 0)
    d1, d2, best, n_cand = (np.asarray(a) for a in (d1, d2, best, n_cand))

    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    knn = bf.knnMatch(_to_cv_desc(qd), _to_cv_desc(td), k=2, mask=mask)

    dmat = np.asarray(d)
    for i, ms in enumerate(knn):
        if n_cand[i] == 0:
            assert len(ms) == 0
            continue
        assert len(ms) == min(2, n_cand[i])
        assert d1[i] == ms[0].distance
        # the best index must agree whenever the minimum is unique
        row = dmat[i][mask[i] > 0]
        if (row == ms[0].distance).sum() == 1:
            assert best[i] == ms[0].trainIdx
        if n_cand[i] >= 2:
            assert d2[i] == ms[1].distance

    # reference acceptance rule applied to both backends agrees wherever
    # the 2-NN sets are unambiguous
    ours = np.asarray(hamming.accept_matches(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(best),
        jnp.asarray(n_cand), 0.8, 30.0))
    for i, ms in enumerate(knn):
        if n_cand[i] >= 2 and dmat[i][mask[i] > 0].min() != d2[i]:
            cv_accept = ms[0].distance < 0.8 * ms[1].distance
            assert (ours[i] >= 0) == cv_accept
        elif n_cand[i] == 1:
            assert (ours[i] >= 0) == (ms[0].distance <= 30.0)


# ---------------------------------------------------------------- PnP
def _make_scene(rng, m=80, outlier_frac=0.15, noise=0.4):
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    pts = np.stack([
        rng.uniform(-4, 4, m), rng.uniform(-3, 3, m), rng.uniform(4, 12, m),
    ], -1)
    # ground-truth camera-in-world pose: small rotation + translation
    rvec_gt = np.array([0.03, -0.05, 0.02])
    t_wc_gt = np.array([0.3, -0.2, 0.5])  # world->camera translation
    r_wc_gt, _ = cv2.Rodrigues(rvec_gt)
    p_cam = pts @ r_wc_gt.T + t_wc_gt
    obs = np.stack([
        fx * p_cam[:, 0] / p_cam[:, 2] + cx,
        fy * p_cam[:, 1] / p_cam[:, 2] + cy,
    ], -1) + rng.randn(m, 2) * noise
    n_out = int(m * outlier_frac)
    out_idx = rng.choice(m, n_out, replace=False)
    obs[out_idx] += rng.uniform(15, 60, (n_out, 2)) * np.sign(rng.randn(n_out, 2))
    inlier_true = np.ones(m, bool)
    inlier_true[out_idx] = False
    return (fx, fy, cx, cy), pts, obs, (r_wc_gt, t_wc_gt), inlier_true


def test_solve_pnp_matches_opencv(rng):
    (fx, fy, cx, cy), pts, obs, (r_wc_gt, t_wc_gt), inlier_true = \
        _make_scene(rng)
    k_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    # ours: start from a perturbed initial pose (camera-in-world)
    r_wc0, _ = cv2.Rodrigues(np.array([0.0, 0.0, 0.0]))
    t_cw0 = -r_wc0.T @ (t_wc_gt + np.array([0.2, -0.15, 0.3]))
    init = Pose(jnp.asarray(t_cw0, jnp.float32),
                quat.from_matrix(jnp.asarray(r_wc0.T, jnp.float32)))
    res = solve_pnp(
        init, jnp.asarray(pts, jnp.float32), jnp.asarray(obs, jnp.float32),
        jnp.ones(len(pts), jnp.float32),
        fx=fx, fy=fy, cx=cx, cy=cy,
    )
    t_est = np.asarray(res.pose.t)          # camera center in world
    r_est = np.asarray(quat.to_matrix(res.pose.q))   # camera-to-world
    inl_est = np.asarray(res.inlier_mask)

    # OpenCV: RANSAC + iterative LM refinement on its inliers
    ok, rvec, tvec, inl = cv2.solvePnPRansac(
        pts.astype(np.float64), obs.astype(np.float64), k_mat, None,
        reprojectionError=np.sqrt(5.991), iterationsCount=200,
        flags=cv2.SOLVEPNP_ITERATIVE,
    )
    assert ok
    rvec, tvec = cv2.solvePnPRefineLM(
        pts[inl[:, 0]].astype(np.float64), obs[inl[:, 0]].astype(np.float64),
        k_mat, None, rvec, tvec)
    r_wc_cv, _ = cv2.Rodrigues(rvec)
    t_cv = (-r_wc_cv.T @ tvec.reshape(3))   # camera center in world
    r_cv = r_wc_cv.T

    # pose agreement: camera center within 2 cm, rotation within 0.2 deg
    assert np.linalg.norm(t_est - t_cv) < 0.02, (t_est, t_cv)
    cosang = (np.trace(r_est.T @ r_cv) - 1.0) / 2.0
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 0.2

    # both recover the true pose (sanity that the test is discriminative)
    t_gt = -r_wc_gt.T @ t_wc_gt
    assert np.linalg.norm(t_est - t_gt) < 0.03

    # inlier sets: ours vs ground truth and vs OpenCV's consensus
    assert (inl_est & ~inlier_true).sum() <= 2       # few false inliers
    assert (inl_est & inlier_true).sum() >= 0.9 * inlier_true.sum()
    cv_inl = np.zeros(len(pts), bool)
    cv_inl[inl[:, 0]] = True
    agree = (inl_est == cv_inl).mean()
    assert agree > 0.9, agree


# ---------------------------------------------------------------- triangulation
def test_triangulate_stereo_matches_opencv(rng):
    """De-circularized triangulation: our batched linear-LS normal-equation
    solve vs cv2.triangulatePoints (4x3 SVD on the same DLT system) on a
    rectified stereo rig with pixel noise (reference backend:
    lvt/src/lvt_local_map.cpp:258-329)."""
    from lvt_tpu.geometry.se3 import Pose
    from lvt_tpu.geometry import quaternion as quat
    from lvt_tpu.ops.triangulate import triangulate_stereo

    fx = fy = 450.0
    cx, cy = 320.0, 240.0
    b = 0.35
    n = 120
    pts = np.stack([
        rng.uniform(-5, 5, n), rng.uniform(-3, 3, n), rng.uniform(3, 25, n),
    ], -1)
    uv_l = np.stack([fx * pts[:, 0] / pts[:, 2] + cx,
                     fy * pts[:, 1] / pts[:, 2] + cy], -1)
    pr = pts - [b, 0.0, 0.0]
    uv_r = np.stack([fx * pr[:, 0] / pr[:, 2] + cx,
                     fy * pr[:, 1] / pr[:, 2] + cy], -1)
    uv_l += rng.randn(n, 2) * 0.3
    uv_r += rng.randn(n, 2) * 0.3

    identity = Pose(jnp.zeros(3), jnp.asarray([1.0, 0, 0, 0]))
    res = triangulate_stereo(
        jnp.asarray(uv_l, jnp.float32), jnp.asarray(uv_r, jnp.float32),
        jnp.ones(n, bool), identity,
        fx=fx, fy=fy, cx=cx, cy=cy, baseline=b,
        near=0.1, far=100.0, min_x=0, max_x=640, min_y=0, max_y=480,
        reprojection_th2=5.991,
    )
    ours = np.asarray(res.points_cam, np.float64)
    valid = np.asarray(res.valid)
    # some sampled points legitimately fall outside the 640x480 frustum or
    # the chi2 gate; the comparison below runs on the surviving majority
    assert valid.mean() > 0.6 and valid.sum() > 60

    k_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    p_l = k_mat @ np.hstack([np.eye(3), np.zeros((3, 1))])
    p_r = k_mat @ np.hstack([np.eye(3), np.array([[-b], [0.0], [0.0]])])
    x4 = cv2.triangulatePoints(p_l, p_r, uv_l.T, uv_r.T)
    cv = (x4[:3] / x4[3]).T

    # same linear system, different solver (normal equations vs SVD):
    # agreement to numerical tolerance, and both near the true points
    err = np.linalg.norm(ours[valid] - cv[valid], axis=-1)
    rel = err / np.linalg.norm(cv[valid], axis=-1)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert (rel < 0.01).mean() > 0.98, (rel < 0.01).mean()
    true_err = np.linalg.norm(ours[valid] - pts[valid], axis=-1)
    cv_err = np.linalg.norm(cv[valid] - pts[valid], axis=-1)
    assert np.median(true_err) < 1.5 * np.median(cv_err) + 1e-3
