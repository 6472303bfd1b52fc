"""Windowed bundle adjustment: joint pose-window + structure refinement via
Schur complement, batched and mesh-shardable.

The reference stops at motion-only BA (g2o with *fixed* points,
lvt/src/lvt_pnp_solver.cpp:76 setFixed(true)) and never refines structure.
This solver goes beyond parity: it jointly optimizes the last F camera poses
and the M map points they observe, eliminating the point block with the
standard Schur complement:

    S       = H_cc - H_cp H_pp^-1 H_cp^T          (reduced camera system)
    g_red   = g_c  - H_cp H_pp^-1 g_p
    dc      = solve(S, -g_red);   dp_m = -H_pp_m^-1 (g_p_m + H_cp[:,m]^T dc)

H_pp is block-diagonal 3x3 per point, so its inverse is a batched closed
form; every sum over points is one einsum — exactly the reduction that
shards over the mesh `points` axis with a psum (see
tests/test_bundle.py::test_sharded_matches_unsharded, BASELINE.json config 5).

Stereo observations: when `baseline > 0` and right-camera observations are
given, both cameras' reprojections constrain the same pose variable — this
pins the scale gauge that a monocular window (with only pose 0 fixed) leaves
free. Cauchy-robust, LM-damped; pose 0 gauge-fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import HIGHEST, Pose
from lvt_tpu.solver import pnp as pnp_mod


class BAResult(NamedTuple):
    poses: Pose          # [F] refined camera-in-world poses
    points: jnp.ndarray  # [M, 3] refined world points
    chi2: jnp.ndarray    # robust total error after refinement
    n_obs: jnp.ndarray   # observations used


def _poses_to_w2c(poses: Pose):
    r_cw = quat.to_matrix(poses.q)            # [F, 3, 3]
    r_wc = jnp.swapaxes(r_cw, -1, -2)
    t_wc = -jnp.einsum("fij,fj->fi", r_wc, poses.t, precision=HIGHEST)
    return r_wc, t_wc


def _w2c_to_poses(r_wc, t_wc) -> Pose:
    r_cw = jnp.swapaxes(r_wc, -1, -2)
    return Pose(-jnp.einsum("fij,fj->fi", r_cw, t_wc, precision=HIGHEST),
                quat.from_matrix(r_cw))


def _inv33(m, damp):
    """Batched inverse of (m + damp*I) via adjugate."""
    m = m + damp * jnp.eye(3, dtype=m.dtype)
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _skew(p):
    """[..., 3, 3] cross-product matrix."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zeros, -z, y], -1),
        jnp.stack([z, zeros, -x], -1),
        jnp.stack([-y, x, zeros], -1),
    ], -2)


def chi2_gate_weights(
    poses: Pose,          # [F] camera-in-world (left camera)
    points: jnp.ndarray,  # [M, 3]
    obs: jnp.ndarray,     # [F, M, 2]
    w: jnp.ndarray,       # [F, M]
    *,
    fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: jnp.ndarray | None = None,
    w_right: jnp.ndarray | None = None,
    gate_th2: float = 0.5,
    psum_axis: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """Per-observation chi-square gate at the CURRENT state, applied before
    windowed BA so that *mismatched* observations (a nearby wrong feature
    associated into the window — the r4 failure mode that made BA hurt on
    dense-texture worlds, BASELINE.md "+194% on textured") cannot drag
    refined points. Noise must pass while mismatches fail, so the gate
    adapts to the window's own residual scale:

        gate = max(gate_th2, 3 * trimmed_mean(e2))

    where the trimmed mean (observations with e2 <= 4 * plain mean) is a
    psum-compatible robust scale proxy: for chi-square_2 residuals,
    mean = 2 sigma^2 and P(e2 > 3 * mean) = exp(-3) ~ 5%%, so legitimate
    observations survive in any noise regime while isolated mismatches —
    many sigma out — are cut. ``gate_th2`` is only a degenerate-scale
    floor (sub-pixel residual windows), NOT the chi-square 95%% bound: on
    near-noiseless dense texture correct matches are sub-pixel while the
    mismatches that made ungated BA hurt sit at 1-2.4 px — a 5.991 floor
    let them through (measured r5: textured ATE +15%% with the loose
    floor, parity with BA-off at 0.5). All reductions are psums under
    ``psum_axis``, so the gate runs unchanged inside the sharded-map BA.

    Returns gated copies of (w, w_right)."""
    dtype = points.dtype
    fxj = jnp.asarray(fx, dtype)
    fyj = jnp.asarray(fy, dtype)
    cxj = jnp.asarray(cx, dtype)
    cyj = jnp.asarray(cy, dtype)
    psum = (lambda x: jax.lax.psum(x, psum_axis)) if psum_axis else (
        lambda x: x)
    r_wc, t_wc = _poses_to_w2c(poses)

    def block_e2(obs_b, x_off):
        p = (jnp.einsum("fij,mj->fmi", r_wc, points, precision=HIGHEST)
             + t_wc[:, None, :]
             + jnp.asarray([x_off, 0.0, 0.0], dtype))
        z = p[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fxj * p[..., 0] * inv_z + cxj
        v = fyj * p[..., 1] * inv_z + cyj
        r = jnp.stack([u, v], -1) - obs_b
        return jnp.sum(r * r, -1)

    e2_l = block_e2(obs, 0.0)
    w_l = w.astype(dtype)
    e2_all = [e2_l]
    w_all = [w_l]
    if obs_right is not None:
        assert w_right is not None and baseline
        e2_r = block_e2(obs_right, -float(baseline))
        w_r = w_right.astype(dtype)
        e2_all.append(e2_r)
        w_all.append(w_r)

    n = psum(sum(jnp.sum(wb) for wb in w_all))
    n = jnp.maximum(n, 1.0)
    m1 = psum(sum(jnp.sum(wb * e2) for wb, e2 in zip(w_all, e2_all))) / n
    trim = [wb * (e2 <= 4.0 * m1) for wb, e2 in zip(w_all, e2_all)]
    n2 = jnp.maximum(psum(sum(jnp.sum(tb) for tb in trim)), 1.0)
    m2 = psum(sum(jnp.sum(tb * e2) for tb, e2 in zip(trim, e2_all))) / n2
    gate = jnp.maximum(jnp.asarray(gate_th2, dtype), 3.0 * m2)

    w_out = w_l * (e2_l <= gate)
    if obs_right is None:
        return w_out, None
    return w_out, w_r * (e2_r <= gate)


def weighted_point_e2(
    poses: Pose,
    points: jnp.ndarray,
    obs: jnp.ndarray,
    w: jnp.ndarray,
    *,
    fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: jnp.ndarray | None = None,
    w_right: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """[M] per-point weighted sum of squared reprojection errors over the
    window (both stereo blocks). Used as the accept/reject metric for the
    BA structure writeback: the trajectory stays the PnP output, so a
    refined point is only an improvement if it fits the observations
    better under the ORIGINAL window poses."""
    dtype = points.dtype
    fxj = jnp.asarray(fx, dtype)
    fyj = jnp.asarray(fy, dtype)
    cxj = jnp.asarray(cx, dtype)
    cyj = jnp.asarray(cy, dtype)
    r_wc, t_wc = _poses_to_w2c(poses)

    def block(obs_b, w_b, x_off):
        p = (jnp.einsum("fij,mj->fmi", r_wc, points, precision=HIGHEST)
             + t_wc[:, None, :]
             + jnp.asarray([x_off, 0.0, 0.0], dtype))
        z = p[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fxj * p[..., 0] * inv_z + cxj
        v = fyj * p[..., 1] * inv_z + cyj
        r = jnp.stack([u, v], -1) - obs_b
        return jnp.sum(w_b.astype(dtype) * jnp.sum(r * r, -1), axis=0)

    total = block(obs, w, 0.0)
    if obs_right is not None:
        assert w_right is not None and baseline
        total = total + block(obs_right, w_right, -float(baseline))
    return total


class _BAState(NamedTuple):
    r_wc: jnp.ndarray    # [F, 3, 3]
    t_wc: jnp.ndarray    # [F, 3]
    points: jnp.ndarray  # [M, 3]
    lam: jnp.ndarray
    nu: jnp.ndarray
    chi2: jnp.ndarray


def refine_window(
    poses: Pose,          # [F] camera-in-world (left camera)
    points: jnp.ndarray,  # [M, 3]
    obs: jnp.ndarray,     # [F, M, 2] left-camera pixel observations
    w: jnp.ndarray,       # [F, M] observation validity (0/1)
    *,
    fx, fy, cx, cy,
    baseline: float = 0.0,
    obs_right: jnp.ndarray | None = None,  # [F, M, 2] right-camera pixels
    w_right: jnp.ndarray | None = None,    # [F, M]
    iterations: int = 8,
    reprojection_th2: float = 5.991,
    psum_axis: str | None = None,
    n_fixed_poses: int = 1,
) -> BAResult:
    """LM-damped Schur-complement BA over an F-pose window.

    With `psum_axis` set (inside shard_map over the point axis), all
    point-reductions become cross-device psums and the identical math runs
    sharded — validated against the unsharded path in tests/test_bundle.py.
    """
    dtype = points.dtype
    f_dim = obs.shape[0]
    fx = jnp.asarray(fx, dtype)
    fy = jnp.asarray(fy, dtype)
    cx = jnp.asarray(cx, dtype)
    cy = jnp.asarray(cy, dtype)
    delta2 = jnp.asarray(reprojection_th2, dtype)

    # observation blocks: (pixels, weights, camera x-offset in left frame)
    blocks = [(obs, w.astype(dtype), 0.0)]
    if obs_right is not None:
        assert w_right is not None and baseline
        blocks.append((obs_right, w_right.astype(dtype), -float(baseline)))

    psum = (lambda x: jax.lax.psum(x, psum_axis)) if psum_axis else (lambda x: x)

    r_wc0, t_wc0 = _poses_to_w2c(poses)

    def block_residuals(r_wc, t_wc, pts, obs_b, x_off):
        """Returns residual r [F,M,2] plus the quantities jacobians need."""
        p_l = (jnp.einsum("fij,mj->fmi", r_wc, pts, precision=HIGHEST)
               + t_wc[:, None, :])
        p = p_l + jnp.asarray([x_off, 0.0, 0.0], dtype)
        z = p[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fx * p[..., 0] * inv_z + cx
        v = fy * p[..., 1] * inv_z + cy
        r = jnp.stack([u, v], -1) - obs_b
        return r, p_l, p, inv_z

    def robust_chi2(r_wc, t_wc, pts):
        total = jnp.asarray(0.0, dtype)
        for obs_b, w_b, x_off in blocks:
            r, _, _, _ = block_residuals(r_wc, t_wc, pts, obs_b, x_off)
            e2 = jnp.sum(r * r, -1)
            total = total + jnp.sum(w_b * delta2 * jnp.log1p(e2 / delta2))
        return psum(total)

    def block_jacobians(r_wc, p_l, p, inv_z):
        """(jc [F,M,2,6], jp [F,M,2,3]) for one observation block."""
        x, y = p[..., 0], p[..., 1]
        fxz = fx * inv_z
        fyz = fy * inv_z
        zeros = jnp.zeros_like(fxz)
        # dpi/dp at the projecting camera point p: [F,M,2,3]
        dpi = jnp.stack([
            jnp.stack([fxz, zeros, -fxz * x * inv_z], -1),
            jnp.stack([zeros, fyz, -fyz * y * inv_z], -1),
        ], -2)
        # dp/dxi = [I | -[p_l]x] (pose perturbation acts on the left frame)
        dp_dxi = jnp.concatenate([
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), p_l.shape[:-1] + (3, 3)),
            -_skew(p_l),
        ], axis=-1)  # [F, M, 3, 6]
        jc = jnp.einsum("fmij,fmjk->fmik", dpi, dp_dxi, precision=HIGHEST)
        jp = jnp.einsum("fmij,fjk->fmik", dpi, r_wc, precision=HIGHEST)
        return jc, jp

    def iteration(state: _BAState):
        h_cc = jnp.zeros((f_dim, 6, 6), dtype)
        h_cp = jnp.zeros((f_dim, state.points.shape[0], 6, 3), dtype)
        h_pp = jnp.zeros((state.points.shape[0], 3, 3), dtype)
        g_c = jnp.zeros((f_dim, 6), dtype)
        g_p = jnp.zeros((state.points.shape[0], 3), dtype)

        for obs_b, w_b, x_off in blocks:
            r, p_l, p, inv_z = block_residuals(
                state.r_wc, state.t_wc, state.points, obs_b, x_off
            )
            e2 = jnp.sum(r * r, -1)
            wr = w_b * pnp_mod._cauchy_weights(e2, delta2)
            jc, jp = block_jacobians(state.r_wc, p_l, p, inv_z)
            jc_w = jc * wr[..., None, None]
            h_cc = h_cc + jnp.einsum("fmki,fmkj->fij", jc_w, jc,
                                     precision=HIGHEST)
            h_cp = h_cp + jnp.einsum("fmki,fmkj->fmij", jc_w, jp,
                                     precision=HIGHEST)
            h_pp = h_pp + jnp.einsum("fmki,fmkj,fm->mij", jp, jp, wr,
                                     precision=HIGHEST)
            g_c = g_c + jnp.einsum("fmki,fmk->fi", jc_w, r, precision=HIGHEST)
            g_p = g_p + jnp.einsum("fmki,fmk,fm->mi", jp, r, wr,
                                   precision=HIGHEST)

        h_cc = psum(h_cc)
        g_c = psum(g_c)

        lam = state.lam
        hpp_inv = _inv33(h_pp, lam)                            # [M, 3, 3]

        # Schur complement onto the camera block
        hcp_hppinv = jnp.einsum("fmij,mjk->fmik", h_cp, hpp_inv,
                                precision=HIGHEST)
        s = -psum(jnp.einsum("fmik,gmjk->fgij", hcp_hppinv, h_cp,
                             precision=HIGHEST))
        diag = h_cc + lam * jnp.eye(6, dtype=dtype)[None]
        s = s.at[jnp.arange(f_dim), jnp.arange(f_dim)].add(diag)
        g_red = g_c - psum(jnp.einsum("fmik,mk->fi", hcp_hppinv, g_p,
                                      precision=HIGHEST))

        # gauge fix: the n_fixed_poses oldest poses held fixed (identity
        # rows/cols + zero rhs); fixing >= 2 poses also anchors the scale of
        # a monocular window
        s_flat = s.transpose(0, 2, 1, 3).reshape(6 * f_dim, 6 * f_dim)
        g_flat = g_red.reshape(6 * f_dim)
        fix = jnp.arange(6 * f_dim) < 6 * n_fixed_poses
        s_flat = jnp.where(fix[:, None] | fix[None, :],
                           jnp.eye(6 * f_dim, dtype=dtype), s_flat)
        g_flat = jnp.where(fix, 0.0, g_flat)

        dc = jnp.linalg.solve(s_flat, -g_flat).reshape(f_dim, 6)
        dp = -jnp.einsum(
            "mij,mj->mi", hpp_inv,
            g_p + jnp.einsum("fmij,fi->mj", h_cp, dc, precision=HIGHEST), precision=HIGHEST)

        retr = jax.vmap(pnp_mod._retract)
        r_new, t_new = retr(state.r_wc, state.t_wc, dc)
        pts_new = state.points + dp
        chi2_new = robust_chi2(r_new, t_new, pts_new)
        ok = (
            (chi2_new < state.chi2)
            & jnp.all(jnp.isfinite(dc))
            & jnp.all(jnp.isfinite(dp))
        )
        return _BAState(
            r_wc=jnp.where(ok, r_new, state.r_wc),
            t_wc=jnp.where(ok, t_new, state.t_wc),
            points=jnp.where(ok, pts_new, state.points),
            lam=jnp.where(ok, state.lam / 3.0, state.lam * state.nu),
            nu=jnp.where(ok, jnp.asarray(2.0, dtype), state.nu * 2.0),
            chi2=jnp.where(ok, chi2_new, state.chi2),
        )

    if psum_axis:
        # under shard_map, psum outputs carry the "varying" axis type; the
        # loop carry must be marked varying up front to match
        mark = lambda x: jax.lax.pcast(x, (psum_axis,), to="varying")
    else:
        mark = lambda x: x
    state = _BAState(
        r_wc=mark(r_wc0), t_wc=mark(t_wc0), points=points,
        lam=mark(jnp.asarray(1e-4, dtype)), nu=mark(jnp.asarray(2.0, dtype)),
        chi2=mark(robust_chi2(r_wc0, t_wc0, points)),
    )
    state = jax.lax.fori_loop(0, iterations, lambda _, s: iteration(s), state)

    n_obs = sum(jnp.sum(w_b > 0) for _, w_b, _ in blocks)
    poses_out = _w2c_to_poses(state.r_wc, state.t_wc)
    chi2_out = state.chi2
    if psum_axis:
        # pose/chi2 are numerically replicated across the point shards but
        # typed "varying"; a pmax (identity on replicated values) restores
        # the replicated/invariant type for shard_map out_specs
        unvary = lambda x: jax.lax.pmax(x, psum_axis)
        poses_out = jax.tree.map(unvary, poses_out)
        chi2_out = unvary(chi2_out)
    return BAResult(
        poses=poses_out,
        points=state.points,
        chi2=chi2_out,
        n_obs=psum(n_obs),
    )
