"""Distributed bundle-adjustment reductions over the device mesh.

The reference's g2o solve is single-threaded on one CPU
(lvt/src/lvt_pnp_solver.cpp:44-52). For the sharded-map
config (BASELINE.json config 5: sharded map blocks), the normal-equation
accumulation H = sum_i w_i J_i^T J_i and g = sum_i w_i J_i^T r_i is an
embarrassingly shardable reduction: map-point blocks live on different
devices, each computes its [6,6]/[6] partials locally, and one `psum` over
the `points` mesh axis produces the global system — the Schur-style
block reduction of SURVEY.md section 2 (distributed-BA inventory). The tiny 6x6
solve and the pose retraction are replicated on every device, so the LM loop
state stays consistent without further communication.

The sharded math itself lives in lvt_tpu.solver.pnp.solve_pnp(axis_name=...)
— the same code the sharded-map tracking step (parallel/sharded_stream.py)
calls inside its shard_map; this module is the standalone entry point for
sharding just the PnP solve.
"""

from __future__ import annotations

import jax
from jax.sharding import PartitionSpec as P

shard_map = jax.shard_map

from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.parallel.mesh import POINT_AXIS
from lvt_tpu.solver import pnp as pnp_mod


def solve_pnp_sharded(
    initial_pose: Pose,
    points,    # [M, 3] — M divisible by the point-axis size
    obs,       # [M, 2]
    weights,   # [M]
    mesh,
    *,
    fx, fy, cx, cy,
    reprojection_th2: float = 5.991,
    axis: str = POINT_AXIS,
) -> pnp_mod.PnPResult:
    """Identical math to lvt_tpu.solver.pnp.solve_pnp, with the residual
    blocks sharded over `axis` and every reduction psum'd over the mesh.
    Validated against the single-device path on identical inputs
    (tests/test_parallel.py)."""

    def body(points_s, obs_s, w_s, pose_t, pose_q):
        return pnp_mod.solve_pnp(
            Pose(pose_t, pose_q), points_s, obs_s, w_s,
            fx=fx, fy=fy, cx=cx, cy=cy,
            reprojection_th2=reprojection_th2, axis_name=axis,
        )

    shard = P(axis)
    rep = P()
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(shard, shard, shard, rep, rep),
        out_specs=pnp_mod.PnPResult(
            pose=Pose(rep, rep), inlier_mask=shard,
            inlier_count=rep, chi2=rep,
        ),
        check_vma=False,
    )(points, obs, weights, initial_pose.t, initial_pose.q)
