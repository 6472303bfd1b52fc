"""VO state pytrees: fixed-capacity point stores and the full VOState.

Equivalent of the reference's mutable object graph
(lvt_local_map's std::vector<lvt_map_point> map + staged arrays,
lvt/src/lvt_local_map.h:64-85; lvt_system's pose/state-machine/match-window
members, lvt/src/lvt_system.h:92-108). Everything is a fixed-shape
structure-of-arrays with validity masks, so one `track_step` jit serves every
frame, and `vmap` over a leading axis gives multi-stream VO for free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lvt_tpu.config import MATCHES_WINDOW_INIT
from lvt_tpu.core.motion import MotionState
from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.ops.hamming import DESC_WORDS

# tracking-state machine values (reference lvt_system.h:45-50)
NOT_INITIALIZED = 1
TRACKING = 2
LOST = 3

N_MATCHES_WINDOW = 3  # reference lvt_system.h:102-104


class PointStore(NamedTuple):
    """Fixed-capacity SoA of 3D points (used for both map and staged sets).

    `counter` means *failed-to-track frames* for map points and
    *successfully-tracked frames* for staged points, mirroring the
    reference's dual use of lvt_map_point::m_counter
    (lvt_local_map.h:64-72, :355-391)."""

    pos: jnp.ndarray      # [N, 3] float32 world position
    desc: jnp.ndarray     # [N, DESC_WORDS] uint32 BRIEF descriptor
    counter: jnp.ndarray  # [N] int32
    age: jnp.ndarray      # [N] int32 frames tracked
    valid: jnp.ndarray    # [N] bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    def size(self) -> jnp.ndarray:
        return jnp.sum(self.valid, axis=-1)

    @staticmethod
    def empty(capacity: int) -> "PointStore":
        return PointStore(
            pos=jnp.zeros((capacity, 3), jnp.float32),
            desc=jnp.zeros((capacity, DESC_WORDS), jnp.uint32),
            counter=jnp.zeros((capacity,), jnp.int32),
            age=jnp.zeros((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool),
        )


class ObsWindow(NamedTuple):
    """Sliding observation window for local bundle adjustment (opt-in;
    no reference counterpart — the reference never refines structure).

    Frame axis is oldest-first; the point axis aligns with the map's slot
    indices, so observation history follows map points for free and is
    invalidated when a slot is culled or recycled."""

    poses_t: jnp.ndarray  # [F, 3]
    poses_q: jnp.ndarray  # [F, 4]
    obs: jnp.ndarray      # [F, M, 2] left-camera pixel observations
    w: jnp.ndarray        # [F, M] observation validity 0/1
    obs_r: jnp.ndarray    # [F, M, 2] right-camera pixel observations
    w_r: jnp.ndarray      # [F, M] right validity (stereo pins point depth)
    n: jnp.ndarray        # [] int32 frames accumulated (saturates at F)

    @staticmethod
    def empty(window: int, capacity: int) -> "ObsWindow":
        return ObsWindow(
            poses_t=jnp.zeros((window, 3), jnp.float32),
            poses_q=jnp.tile(quat.identity()[None], (window, 1)),
            obs=jnp.zeros((window, capacity, 2), jnp.float32),
            w=jnp.zeros((window, capacity), jnp.float32),
            obs_r=jnp.zeros((window, capacity, 2), jnp.float32),
            w_r=jnp.zeros((window, capacity), jnp.float32),
            n=jnp.asarray(0, jnp.int32),
        )


class VOState(NamedTuple):
    map: PointStore
    staged: PointStore
    pose: Pose                 # last successfully tracked pose
    motion: MotionState
    last_matches: jnp.ndarray  # [3] float32, oldest-first match counts
    frame_number: jnp.ndarray  # [] int32
    status: jnp.ndarray        # [] int32 (NOT_INITIALIZED/TRACKING/LOST)
    ba: ObsWindow              # local-BA observation window ([0]-sized if off)

    @staticmethod
    def initial(max_map_points: int, max_staged_points: int,
                ba_window: int = 0) -> "VOState":
        return VOState(
            map=PointStore.empty(max_map_points),
            staged=PointStore.empty(max_staged_points),
            pose=Pose.identity(),
            motion=MotionState.initial(),
            last_matches=jnp.full((N_MATCHES_WINDOW,), MATCHES_WINDOW_INIT,
                                  jnp.float32),
            frame_number=jnp.asarray(0, jnp.int32),
            status=jnp.asarray(NOT_INITIALIZED, jnp.int32),
            ba=ObsWindow.empty(ba_window, max_map_points),
        )


class StepMetrics(NamedTuple):
    """Per-frame observability, superset of the reference's 10 recorded
    series (lvt_system.cpp:339-349) with per-point series aggregated to
    means (a jitted step returns scalars, not ragged lists)."""

    map_points_count: jnp.ndarray
    staged_points_count: jnp.ndarray
    image_keypoints: jnp.ndarray
    tracked_map_points: jnp.ndarray
    mean_age: jnp.ndarray
    mean_closest_descriptor_distance: jnp.ndarray
    mean_second_descriptor_distance: jnp.ndarray
    mean_feature_x: jnp.ndarray
    mean_feature_y: jnp.ndarray
    inlier_count: jnp.ndarray
    # extras beyond the reference
    triangulated_points: jnp.ndarray
    used_wide_radius: jnp.ndarray
    status: jnp.ndarray

    @staticmethod
    def zero() -> "StepMetrics":
        z = jnp.asarray(0, jnp.int32)
        f = jnp.asarray(0.0, jnp.float32)
        return StepMetrics(z, z, z, z, f, f, f, f, f, z, z,
                           jnp.asarray(False), z)
