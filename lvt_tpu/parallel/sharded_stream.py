"""Sharded-map single-stream tracking — BASELINE config 5 in the pipeline.

One camera stream whose local map is too large for (or deliberately spread
over) a single chip: the ``PointStore`` blocks (map, staged, and the BA
observation window's point axis) shard over the ``points`` mesh axis, while
images, features and the pose state stay replicated. The whole tracking step
runs inside ONE ``shard_map``:

  * per-map-point work (projection, visibility, Hamming rows, counters,
    insert/cull) is local to its shard;
  * the cross-shard quantities reduce over the mesh — match counts and map sizes
    with `psum`, the one-to-one match claims with `pmin` over a combined
    (distance, global-index) key (ops/hamming.resolve_one_to_one), the PnP /
    windowed-BA normal equations with the Schur-style `psum` block reduction
    (solver/pnp.solve_pnp(axis_name=...), solver/bundle.refine_window);
  * new triangulations are partitioned round-robin across shards.

Numerically this computes the same map SET and the same pose trajectory as
the unsharded step (slot layout differs; float reduction order may perturb
the LM at the last ulp) — asserted by tests/test_sharded_stream.py on
identical frames. Caveat at capacity: insertions partition across shards by
valid-candidate rank, so once an individual shard's block fills, its subset
of new points drops even if another shard still has free slots — whereas
the unsharded map fills any global free slot. Size the per-shard capacity
(max_map_points / n_shards) with the same headroom you would give a single
chip; the equivalence guarantee holds below that fill level. The reference
has no counterpart (single-threaded C++); this is the SURVEY.md §2
parallelism-inventory item (c).
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract, step as step_mod
from lvt_tpu.core.motion import MotionState
from lvt_tpu.core.state import ObsWindow, PointStore, StepMetrics, VOState
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.parallel.mesh import POINT_AXIS

shard_map = jax.shard_map


def _store_specs(axis: str) -> PointStore:
    s = P(axis)
    return PointStore(pos=s, desc=s, counter=s, age=s, valid=s)


def state_specs(axis: str = POINT_AXIS) -> VOState:
    """PartitionSpec pytree for a VOState with point stores sharded."""
    rep = P()
    return VOState(
        map=_store_specs(axis),
        staged=_store_specs(axis),
        pose=Pose(rep, rep),
        motion=MotionState(rep, rep, rep, rep),
        last_matches=rep,
        frame_number=rep,
        status=rep,
        ba=ObsWindow(
            poses_t=rep, poses_q=rep,
            obs=P(None, axis), w=P(None, axis),
            obs_r=P(None, axis), w_r=P(None, axis), n=rep,
        ),
    )


def _rep_like(tree):
    return jax.tree.map(lambda _: P(), tree)


def _metrics_specs() -> StepMetrics:
    return _rep_like(StepMetrics.zero())


@functools.partial(jax.jit, static_argnames=("config", "mesh", "axis"))
def track_step_stereo_sharded(
    state: VOState, img_left: jnp.ndarray, img_right: jnp.ndarray,
    config: VOConfig, mesh, axis: str = POINT_AXIS,
):
    """One stereo frame with the map sharded over the `axis` mesh axis."""
    left, right = extract.extract_features_stereo(img_left, img_right, config)
    specs = state_specs(axis)
    feat_rep = _rep_like(left)
    fn = shard_map(
        lambda st, l, r: step_mod.track_features(
            st, l, r, config, rgbd=False, axis_name=axis
        ),
        mesh=mesh,
        in_specs=(specs, feat_rep, feat_rep),
        out_specs=(specs, Pose(P(), P()), _metrics_specs()),
        check_vma=False,
    )
    return fn(state, left, right)


@functools.partial(jax.jit, static_argnames=("config", "mesh", "axis"))
def track_chunk_stereo_sharded(
    state: VOState,
    imgs_left: jnp.ndarray,   # [N, H, W]
    imgs_right: jnp.ndarray,  # [N, H, W]
    config: VOConfig, mesh, axis: str = POINT_AXIS,
):
    """Chunked sharded-map tracking: one dispatch per N-frame chunk."""
    specs = state_specs(axis)

    def body(st, frame):
        il, ir = frame
        left, right = extract.extract_features_stereo(
            il.astype(jnp.float32), ir.astype(jnp.float32), config
        )
        feat_rep = _rep_like(left)
        st2, pose, metrics = shard_map(
            lambda s, l, r: step_mod.track_features(
                s, l, r, config, rgbd=False, axis_name=axis
            ),
            mesh=mesh,
            in_specs=(specs, feat_rep, feat_rep),
            out_specs=(specs, Pose(P(), P()), _metrics_specs()),
            check_vma=False,
        )(st, left, right)
        return st2, (pose, metrics)

    state, (poses, metrics) = jax.lax.scan(body, state, (imgs_left, imgs_right))
    return state, poses, metrics


class ShardedStreamVO:
    """Driver for one VO stream with a mesh-sharded local map (config 5)."""

    def __init__(self, config: VOConfig, mesh=None, axis: str = POINT_AXIS):
        config.validate()
        self.config = config
        self.axis = axis
        if mesh is None:
            mesh = jax.sharding.Mesh(np.array(jax.devices()), (axis,))
        self.mesh = mesh
        n_shards = mesh.shape[axis]
        assert config.max_map_points % n_shards == 0, (
            "max_map_points must divide evenly over the point shards"
        )
        assert config.max_staged_points % n_shards == 0
        state = VOState.initial(
            config.max_map_points, config.max_staged_points,
            config.local_ba_window,
        )
        self.state = jax.device_put(
            state,
            jax.tree.map(lambda s: NamedSharding(mesh, s), state_specs(axis)),
        )
        self._metrics_lock = threading.Lock()
        self.last_metrics = None

    # deferred final-frame slice after track_chunk — see
    # core/system.py: the eager per-leaf slice would otherwise put ~13
    # tiny dispatches inside the serving hot loop; lock-guarded so a
    # monitor thread can read concurrently with a tracking thread
    @property
    def last_metrics(self):
        with self._metrics_lock:
            if self._pending_chunk_metrics is not None:
                self._last_metrics = jax.tree.map(
                    lambda x: x[-1], self._pending_chunk_metrics
                )
                self._pending_chunk_metrics = None
            return self._last_metrics

    @last_metrics.setter
    def last_metrics(self, value):
        with self._metrics_lock:
            self._last_metrics = value
            self._pending_chunk_metrics = None

    def track(self, img_left, img_right) -> Pose:
        self.state, pose, self.last_metrics = track_step_stereo_sharded(
            self.state, jnp.asarray(img_left, jnp.float32),
            jnp.asarray(img_right, jnp.float32), self.config, self.mesh,
            self.axis,
        )
        return pose

    def track_chunk(self, imgs_left, imgs_right):
        self.state, poses, metrics = track_chunk_stereo_sharded(
            self.state, jnp.asarray(imgs_left), jnp.asarray(imgs_right),
            self.config, self.mesh, self.axis,
        )
        with self._metrics_lock:
            self._last_metrics = None
            self._pending_chunk_metrics = metrics
        return poses, metrics

    @property
    def map_size(self) -> int:
        return int(self.state.map.size())

    @property
    def status(self) -> int:
        return int(self.state.status)
