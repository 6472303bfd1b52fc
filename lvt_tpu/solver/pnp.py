"""Motion-only bundle adjustment: robust Levenberg-Marquardt PnP on SE(3).

Replacement for the reference's g2o stack (lvt/src/lvt_pnp_solver.cpp:
44-128): one free camera vertex, fixed 3D points, monocular reprojection edges
with identity information and a Cauchy robust kernel (delta = sqrt(5.991)),
optimized with Levenberg-Marquardt in 2 passes of 5 iterations; after each
pass, edges with raw chi2 > 5.991 are demoted (excluded from the next pass).

Here the entire "g2o equivalent" is ~100 lines of jnp: analytic 2x6 Jacobians,
Cauchy reweighting, a 6x6 normal-equation solve, and `lax.fori_loop` for the
fixed iteration schedule (no early exit under jit — rejected steps keep the
state and only adapt lambda, exactly LM's behavior). All residuals across map
points are batched; the per-iteration reduction J^T W J is a [6,6] einsum (a
matrix product for XLA). The same accumulation is what shards over a device mesh
with `psum` for the distributed-BA path (see lvt_tpu.parallel.ba).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import HIGHEST, Pose

N_PASSES = 2          # lvt_pnp_solver.cpp:42 (#define N_PASSES 2)
N_ITERS_PER_PASS = 5  # m_optimizer->optimize(5), lvt_pnp_solver.cpp:106
LM_TAU = 1e-5         # g2o's initial lambda heuristic: tau * max(diag(H))


class PnPResult(NamedTuple):
    pose: Pose
    inlier_mask: jnp.ndarray   # [M] bool (weights > 0 in final pass)
    inlier_count: jnp.ndarray  # [] int32
    chi2: jnp.ndarray          # [] float32 robust total error


def _project_residuals(r_wc, t_wc, points, obs, fx, fy, cx, cy):
    """Residuals r = proj(p_cam) - obs and per-point camera coords."""
    p_cam = jnp.matmul(points, r_wc.T, precision=HIGHEST) + t_wc
    z = p_cam[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / safe_z
    u = fx * p_cam[:, 0] * inv_z + cx
    v = fy * p_cam[:, 1] * inv_z + cy
    r = jnp.stack([u, v], -1) - obs
    return r, p_cam, inv_z


def _jacobians(p_cam, inv_z, fx, fy):
    """Analytic d(proj)/d(xi) for a left-multiplicative update of the
    world->camera transform: p_cam' = exp([w]x) p_cam + v, xi = (v, w)."""
    x, y = p_cam[:, 0], p_cam[:, 1]
    fxz = fx * inv_z
    fyz = fy * inv_z
    fxxz = fxz * x * inv_z  # fx * x / z^2
    fyyz = fyz * y * inv_z
    zeros = jnp.zeros_like(fxz)
    # d(uv)/d(p_cam): [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    # d(p_cam)/d(v) = I ; d(p_cam)/d(w) = -[p_cam]x
    ju = jnp.stack(
        [fxz, zeros, -fxxz,
         -fxxz * y, fx + fxxz * x, -fxz * y],
        -1,
    )
    jv = jnp.stack(
        [zeros, fyz, -fyyz,
         -fy - fyyz * y, fyyz * x, fyz * x],
        -1,
    )
    return jnp.stack([ju, jv], -2)  # [M, 2, 6]


def _cauchy_weights(e2, delta2):
    """rho'(e2) for the Cauchy kernel rho(s) = delta^2 log(1 + s/delta^2)."""
    return 1.0 / (1.0 + e2 / delta2)


def _retract(r_wc, t_wc, delta):
    """Apply xi = (v, w): R' = exp([w]x) R, t' = exp([w]x) t + v."""
    v, w = delta[:3], delta[3:]
    theta2 = jnp.dot(w, w, precision=HIGHEST)
    theta = jnp.sqrt(theta2 + 1e-20)
    half = 0.5 * theta
    # unit quaternion of the rotation increment (small-angle safe)
    sinc = jnp.where(theta < 1e-6, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    dq = jnp.concatenate([jnp.cos(half)[None], sinc * w])
    dr = quat.to_matrix(quat.normalize(dq))
    return (jnp.matmul(dr, r_wc, precision=HIGHEST),
            jnp.matmul(dr, t_wc, precision=HIGHEST) + v)


class _LMState(NamedTuple):
    r_wc: jnp.ndarray
    t_wc: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    chi2: jnp.ndarray
    # cached projection at (r_wc, t_wc): each iteration projects once (for
    # the trial pose) instead of twice, and the pass-end outlier demotion
    # reads the final residuals for free instead of re-projecting
    r: jnp.ndarray       # [M, 2] residuals
    p_cam: jnp.ndarray   # [M, 3]
    inv_z: jnp.ndarray   # [M]
    e2: jnp.ndarray      # [M] squared residual norm


def solve_pnp(
    initial_pose: Pose,
    points: jnp.ndarray,   # [M, 3] world points (fixed)
    obs: jnp.ndarray,      # [M, 2] observed pixels
    weights: jnp.ndarray,  # [M] 0/1 validity of each correspondence
    *,
    fx, fy, cx, cy,
    reprojection_th2: float = 5.991,
    axis_name: str | None = None,
) -> PnPResult:
    """Robust LM PnP with the reference's 2x5 + outlier-demotion schedule.

    With ``axis_name`` set, the point blocks are sharded over that mesh axis
    (inside shard_map) and every scalar reduction — H, g, chi2, inlier
    count — is a `psum` over the mesh: the distributed Schur-style block
    reduction of SURVEY.md §2. Pose state stays replicated on every shard,
    so the LM loop needs no further communication.
    """
    psum = (lambda x: jax.lax.psum(x, axis_name)) if axis_name else (lambda x: x)
    dtype = points.dtype
    fx = jnp.asarray(fx, dtype)
    fy = jnp.asarray(fy, dtype)
    cx = jnp.asarray(cx, dtype)
    cy = jnp.asarray(cy, dtype)
    delta2 = jnp.asarray(reprojection_th2, dtype)

    # optimize the world->camera transform
    r_cw = quat.to_matrix(initial_pose.q)
    r_wc0 = r_cw.T
    t_wc0 = -jnp.matmul(r_wc0, initial_pose.t, precision=HIGHEST)

    def project(r_wc, t_wc):
        r, p_cam, inv_z = _project_residuals(
            r_wc, t_wc, points, obs, fx, fy, cx, cy
        )
        return r, p_cam, inv_z, jnp.sum(r * r, -1)

    def robust_chi2(e2, w_mask):
        rho = delta2 * jnp.log1p(e2 / delta2)
        return psum(jnp.sum(w_mask * rho))

    def lm_iteration(state: _LMState, w_mask):
        w = w_mask * _cauchy_weights(state.e2, delta2)
        jac = _jacobians(state.p_cam, state.inv_z, fx, fy)  # [M, 2, 6]
        # H = sum w J^T J, g = sum w J^T r  (one contraction over all points)
        jw = jac * w[:, None, None]
        h = psum(jnp.einsum("mki,mkj->ij", jw, jac, precision=HIGHEST))
        g = psum(jnp.einsum("mki,mk->i", jw, state.r, precision=HIGHEST))

        step = jnp.linalg.solve(
            h + state.lam * jnp.eye(6, dtype=dtype), -g
        )
        r_wc_new, t_wc_new = _retract(state.r_wc, state.t_wc, step)
        r_new, p_new, iz_new, e2_new = project(r_wc_new, t_wc_new)
        chi2_new = robust_chi2(e2_new, w_mask)
        accept = (chi2_new < state.chi2) & jnp.all(jnp.isfinite(step))
        sel = lambda a, b: jnp.where(accept, a, b)

        return _LMState(
            r_wc=sel(r_wc_new, state.r_wc),
            t_wc=sel(t_wc_new, state.t_wc),
            lam=jnp.where(accept, state.lam / 3.0, state.lam * state.nu),
            nu=jnp.where(accept, jnp.asarray(2.0, dtype), state.nu * 2.0),
            chi2=sel(chi2_new, state.chi2),
            r=sel(r_new, state.r),
            p_cam=sel(p_new, state.p_cam),
            inv_z=sel(iz_new, state.inv_z),
            e2=sel(e2_new, state.e2),
        )

    def run_pass(r_wc, t_wc, w_mask):
        # g2o-style initial lambda: tau * max diagonal of H
        r, p_cam, inv_z, e2 = project(r_wc, t_wc)
        w = w_mask * _cauchy_weights(e2, delta2)
        jac = _jacobians(p_cam, inv_z, fx, fy)
        h_diag = psum(jnp.einsum("m,mki,mki->i", w, jac, jac,
                                precision=HIGHEST))
        lam0 = LM_TAU * jnp.max(h_diag) + 1e-12
        state = _LMState(
            r_wc, t_wc, lam0, jnp.asarray(2.0, dtype),
            robust_chi2(e2, w_mask), r, p_cam, inv_z, e2,
        )
        state = jax.lax.fori_loop(
            0, N_ITERS_PER_PASS, lambda _, s: lm_iteration(s, w_mask), state
        )
        return state

    w_mask = weights.astype(dtype)
    r_wc, t_wc = r_wc0, t_wc0
    for _ in range(N_PASSES):
        state = run_pass(r_wc, t_wc, w_mask)
        r_wc, t_wc = state.r_wc, state.t_wc
        # demotion: raw (non-robust) chi2 > threshold leaves the next pass
        # (and the inlier count), reference lvt_pnp_solver.cpp:108-117;
        # state.e2 is already the residual at the pass-end pose
        w_mask = w_mask * (state.e2 <= delta2)

    inlier_mask = w_mask > 0
    # back to camera-in-world
    r_cw = r_wc.T
    pose = Pose(-jnp.matmul(r_cw, t_wc, precision=HIGHEST),
                quat.from_matrix(r_cw))
    return PnPResult(
        pose=pose,
        inlier_mask=inlier_mask,
        inlier_count=psum(jnp.sum(inlier_mask)),
        chi2=state.chi2,
    )
