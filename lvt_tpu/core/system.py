"""VOSystem — the host-side driver around the jitted track step.

Public API equivalent of the reference's ``lvt_system``
(lvt/src/lvt_system.h:57-70: create/destroy/track/track_with_external_corners/
reset/get_state) and, transitively, of its C ABI (lvt/src/lvt_c.h:57-62) —
in this framework the Python class *is* the public API. The driver holds the
``VOState`` pytree on device; each ``track`` call uploads the frame, runs one
compiled step, and reads back the pose (host<->device = image in, pose out).
"""

from __future__ import annotations

import enum
import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lvt_tpu.config import VOConfig
from lvt_tpu.core import step as step_mod
from lvt_tpu.core.state import StepMetrics, VOState
from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import Pose


class SensorType(enum.IntEnum):
    STEREO = 1
    RGBD = 2


class TrackingState(enum.IntEnum):
    NOT_INITIALIZED = 1
    TRACKING = 2
    LOST = 3


class VOSystem:
    """Visual odometry system over one camera stream."""

    def __init__(
        self,
        config: VOConfig,
        sensor_type: SensorType = SensorType.STEREO,
        metrics_recorder=None,
        trace_log=None,
        log_dir: str = ".",
        rectify_maps: tuple | None = None,
    ):
        config.validate()
        self.config = config
        self.sensor_type = SensorType(sensor_type)
        self.metrics_recorder = metrics_recorder
        # static per-sequence rectification remaps ([H, W, 2] left/right);
        # when set, raw distorted frames go in and the remap runs INSIDE the
        # jitted step (the reference remaps per frame on the CPU,
        # euroc_example.cpp:142-143)
        if rectify_maps is not None:
            assert self.sensor_type == SensorType.STEREO
            self.rectify_maps = (
                jnp.asarray(rectify_maps[0], jnp.float32),
                jnp.asarray(rectify_maps[1], jnp.float32),
            )
        else:
            self.rectify_maps = None
        # trace log wiring mirrors lvt_system::create's LVT_ENABLE_LOG block
        # (lvt_system.cpp:106-116): created when config.enable_logging is
        # set (or injected), parameters dumped at init
        if trace_log is None and config.enable_logging:
            from lvt_tpu.observability import TraceLog

            trace_log = TraceLog(out_dir=log_dir)
        self.trace_log = trace_log
        if self.trace_log is not None:
            self.trace_log.log_params(config)
        self.state = VOState.initial(
            config.max_map_points, config.max_staged_points,
            config.local_ba_window,
        )
        self._metrics_lock = threading.Lock()
        self.last_metrics: Optional[StepMetrics] = None

    # last_metrics is lazy after a chunk dispatch: slicing the final frame
    # out of every metrics leaf is ~13 eager device ops, which would land
    # inside the benchmark/serving hot loop on every track_chunk call; the
    # slice is deferred to first access instead. The pending reference pins
    # the full N-frame metrics pytree on device until first read (or the
    # next track/track_chunk/reset) — callers that never read last_metrics
    # and hold no other reference trade that transient HBM for the faster
    # dispatch. The swap is guarded by a lock so a monitor thread reading
    # last_metrics while a worker thread tracks (the StreamingVO pattern)
    # never observes a torn pending/last pair.
    @property
    def last_metrics(self) -> Optional[StepMetrics]:
        with self._metrics_lock:
            if self._pending_chunk_metrics is not None:
                self._last_metrics = jax.tree.map(
                    lambda x: x[-1], self._pending_chunk_metrics
                )
                self._pending_chunk_metrics = None
            return self._last_metrics

    @last_metrics.setter
    def last_metrics(self, value: Optional[StepMetrics]) -> None:
        with self._metrics_lock:
            self._last_metrics = value
            self._pending_chunk_metrics = None

    # -- lifecycle ------------------------------------------------------
    @staticmethod
    def create(config: VOConfig, sensor_type: SensorType = SensorType.STEREO,
               **kw) -> "VOSystem":
        """Factory mirroring lvt_system::create (lvt_system.cpp:70-127)."""
        return VOSystem(config, sensor_type, **kw)

    def reset(self) -> None:
        """Clear map, motion model and state machine
        (lvt_system::reset, lvt_system.cpp:44-68)."""
        self.state = VOState.initial(
            self.config.max_map_points, self.config.max_staged_points,
            self.config.local_ba_window,
        )
        self.last_metrics = None
        if self.metrics_recorder is not None:
            self.metrics_recorder.reset()
        if self.trace_log is not None:
            self.trace_log.log("VO was just reset.")

    # -- introspection --------------------------------------------------
    def get_state(self) -> TrackingState:
        return TrackingState(int(self.state.status))

    @property
    def frame_number(self) -> int:
        return int(self.state.frame_number)

    @property
    def map_size(self) -> int:
        return int(self.state.map.size())

    @property
    def last_pose(self) -> Pose:
        return self.state.pose

    # -- tracking -------------------------------------------------------
    def _prep_image(self, img) -> jnp.ndarray:
        a = jnp.asarray(img)
        assert a.ndim == 2, "images must be single-channel grayscale"
        assert a.shape == (self.config.img_height, self.config.img_width), (
            f"image shape {a.shape} != configured "
            f"{(self.config.img_height, self.config.img_width)}"
        )
        # uint8 uploads 4x less than float32 and the perception kernel
        # widens on device; other dtypes normalize to float32
        return a if a.dtype == jnp.uint8 else a.astype(jnp.float32)

    def _finish(self, out) -> Pose:
        self.state, pose, metrics = out
        self.last_metrics = metrics
        if self.metrics_recorder is not None:
            self.metrics_recorder.record_step(metrics)
        if self.trace_log is not None:
            # per-frame trace line like the reference's bracketing logs
            # (lvt_system.cpp:159,174,258,265)
            self.trace_log.log(
                f"Frame #{int(self.state.frame_number)}: status="
                f"{TrackingState(int(self.state.status)).name} "
                f"matches={int(metrics.tracked_map_points)} "
                f"inliers={int(metrics.inlier_count)} "
                f"map={int(metrics.map_points_count)} "
                f"keypoints={int(metrics.image_keypoints)}"
            )
        return pose

    def track(self, img1, img2) -> Pose:
        """One frame. Stereo: (left, right) grayscale — raw if rectify_maps
        is set, pre-rectified otherwise. RGB-D: (gray, metric depth)."""
        if self.sensor_type == SensorType.STEREO:
            if self.rectify_maps is not None:
                out = step_mod.track_step_stereo_rectified(
                    self.state, self._prep_image(img1),
                    self._prep_image(img2), *self.rectify_maps, self.config,
                )
            else:
                out = step_mod.track_step_stereo(
                    self.state, self._prep_image(img1),
                    self._prep_image(img2), self.config,
                )
        else:
            depth = jnp.asarray(img2, jnp.float32)
            out = step_mod.track_step_rgbd(
                self.state, self._prep_image(img1), depth, self.config
            )
        return self._finish(out)

    def track_with_external_corners(
        self, left_image, right_image, corners_left, corners_right
    ) -> Pose:
        """Descriptors-only tracking on caller-supplied corner locations
        (lvt_system::track_with_external_corners, lvt_system.cpp:209-250).
        Corner arrays are [N, 2] (x, y); N may differ between calls — they
        are padded to the configured keypoint capacity."""
        cap = self.config.kp_capacity

        def pad(c):
            c = np.asarray(c, np.float32).reshape(-1, 2)
            n = min(len(c), cap)
            out = np.zeros((cap, 2), np.float32)
            out[:n] = c[:n]
            valid = np.zeros(cap, bool)
            valid[:n] = True
            return jnp.asarray(out), jnp.asarray(valid)

        cl, vl = pad(corners_left)
        cr, vr = pad(corners_right)
        out = step_mod.track_step_external_corners(
            self.state, self._prep_image(left_image),
            self._prep_image(right_image), cl, vl, cr, vr, self.config,
        )
        return self._finish(out)

    def track_chunk(self, imgs1, imgs2):
        """Offline/batch mode: process a chunk of N frames in ONE device
        dispatch (lax.scan inside the jit). Semantically identical to N
        `track` calls; returns (poses, metrics) with a leading N axis.

        This is the high-throughput path: the per-frame host
        round-trip of the online mode disappears and the VOState stays on
        device across the whole chunk."""
        a = jnp.asarray(imgs1)
        b = jnp.asarray(
            imgs2, jnp.float32 if self.sensor_type == SensorType.RGBD else None
        )
        assert a.ndim == 3, f"expected [N, H, W] image chunk, got {a.shape}"
        assert b.shape == a.shape, (
            f"second-input chunk {b.shape} != image chunk {a.shape}"
        )
        if self.sensor_type == SensorType.STEREO:
            if self.rectify_maps is not None:
                self.state, poses, metrics = (
                    step_mod.track_chunk_stereo_rectified(
                        self.state, a, b, *self.rectify_maps, self.config
                    )
                )
            else:
                self.state, poses, metrics = step_mod.track_chunk_stereo(
                    self.state, a, b, self.config
                )
        else:
            self.state, poses, metrics = step_mod.track_chunk_rgbd(
                self.state, a, b, self.config
            )
        with self._metrics_lock:
            self._last_metrics = None
            self._pending_chunk_metrics = metrics
        if self.metrics_recorder is not None:
            # one host transfer per series for the whole chunk
            self.metrics_recorder.record_chunk(metrics)
        return poses, metrics

    # -- checkpoint / resume -------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full VOState (a pytree) to disk. The reference has
        no checkpointing at all (SURVEY.md section 5); for long multi-stream runs
        this makes the VO resumable. Leaves are keyed by their pytree path
        (e.g. ``.map.pos``) so a field reorder can never mis-restore state."""
        flat, _ = jax.tree_util.tree_flatten_with_path(self.state)
        arrays = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}
        np.savez(path, _sensor=np.int64(int(self.sensor_type)), **arrays)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        flat, treedef = jax.tree_util.tree_flatten_with_path(self.state)
        named = [k for k in data.files if not k.startswith("_")]
        if any(k.startswith(".") for k in named):
            leaves = [jnp.asarray(data[jax.tree_util.keystr(kp)])
                      for kp, _ in flat]
        else:
            # legacy positional format (arr_0, arr_1, ...) from round 1
            leaves = [jnp.asarray(data[k]) for k in named]
        self.state = jax.tree_util.tree_unflatten(treedef, leaves)


def pose_to_numpy(pose: Pose) -> tuple[np.ndarray, np.ndarray]:
    """(position[3], rotation_matrix[3,3]) on host."""
    return np.asarray(pose.t), np.asarray(quat.to_matrix(pose.q))
