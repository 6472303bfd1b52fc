"""Multi-stream VO: vmapped track steps sharded over the device mesh.

This is the scale-out story of the framework (BASELINE.json configs 4-5;
SURVEY.md section 2 parallelism inventory): N independent camera streams become a
batch axis of the same jitted step (`vmap`), the batch shards across chips
with NamedSharding over the `stream` mesh axis, and per-stream LOST flags
live in the batched VOState so one lost stream never stalls the rest —
"reset" re-initializes just that stream's slice.

The reference is single-stream by construction; this component has no
counterpart there and is specified by BASELINE.json's north star.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lvt_tpu.config import VOConfig
from lvt_tpu.core import step as step_mod
from lvt_tpu.core.state import VOState
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.parallel import mesh as mesh_mod


def batched_initial_state(config: VOConfig, n_streams: int) -> VOState:
    base = VOState.initial(config.max_map_points, config.max_staged_points,
                           config.local_ba_window)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_streams,) + x.shape), base
    )


def _step_stereo_batched(states, imgs_left, imgs_right, config: VOConfig):
    """One frame for every stream. Feature extraction for all 2S images runs
    as ONE batched perception pass; the per-stream tracking body (one
    predicated computation, core/step.track_features) is then vmapped."""
    from lvt_tpu.core import extract

    s = imgs_left.shape[0]
    feats = extract.extract_features_batched(
        jnp.concatenate([imgs_left, imgs_right]), config
    )
    left = jax.tree.map(lambda a: a[:s], feats)
    right = jax.tree.map(lambda a: a[s:], feats)
    return jax.vmap(
        lambda st, l, r: step_mod.track_features(st, l, r, config, rgbd=False)
    )(states, left, right)


def _step_rgbd_batched(states, imgs_gray, imgs_depth, config: VOConfig):
    from lvt_tpu.core import extract

    feats = extract.extract_features_batched(imgs_gray, config)

    def one(st, f, depth):
        f = _apply_depth(f, depth, config)
        return step_mod.track_features(st, f, None, config, rgbd=True)

    return jax.vmap(one)(states, feats, imgs_depth)


@functools.partial(jax.jit, static_argnames=("config",))
def multistream_step_stereo(
    states: VOState,       # batched [S, ...]
    imgs_left: jnp.ndarray,   # [S, H, W]
    imgs_right: jnp.ndarray,  # [S, H, W]
    config: VOConfig,
):
    return _step_stereo_batched(states, imgs_left, imgs_right, config)


@functools.partial(jax.jit, static_argnames=("config",))
def multistream_step_rgbd(
    states: VOState, imgs_gray: jnp.ndarray, imgs_depth: jnp.ndarray,
    config: VOConfig,
):
    return _step_rgbd_batched(states, imgs_gray, imgs_depth, config)


@functools.partial(jax.jit, static_argnames=("config", "auto_reset", "rgbd"),
                   donate_argnums=(0,))
def multistream_chunk(
    states: VOState,          # batched [S, ...]
    imgs1: jnp.ndarray,       # [N, S, H, W] left (or grayscale for RGB-D)
    imgs2: jnp.ndarray,       # [N, S, H, W] right (or float32 depth)
    config: VOConfig,
    auto_reset: bool = True,
    rgbd: bool = False,
):
    """The config-4 benchmark shape: scan N frames of a sharded S-stream
    batch in ONE dispatch. Per-step all 2S (or S) images are one perception
    batch; per-stream LOST handling (optionally) auto-resets inside the scan
    so a lost stream loses at most the remaining frames of the current
    chunk's step, never stalling the others. Returns
    (states, poses [N, S], metrics [N, S])."""

    def body(st, frame):
        a, b = frame
        if rgbd:
            st2, poses, metrics = _step_rgbd_batched(
                st, a, b.astype(jnp.float32), config)
        else:
            st2, poses, metrics = _step_stereo_batched(st, a, b, config)
        if auto_reset:
            st2 = _reset_lost(st2, config)
        return st2, (poses, metrics)

    states, (poses, metrics) = jax.lax.scan(body, states, (imgs1, imgs2))
    return states, poses, metrics


def _apply_depth(feats, img_depth, config: VOConfig):
    """Depth filtering/undistortion of already-extracted features (the
    single-stream rgbd path does this inside extract_features_rgbd)."""
    from lvt_tpu.ops import undistort

    xi = jnp.clip(feats.kp[:, 0].astype(jnp.int32), 0, config.img_width - 1)
    yi = jnp.clip(feats.kp[:, 1].astype(jnp.int32), 0, config.img_height - 1)
    d = img_depth[yi, xi]
    ok = (d >= config.near_plane_distance) & (d <= config.far_plane_distance)
    valid = feats.valid & ok
    if abs(config.k1) > 1e-5:
        kp = undistort.undistort_points(
            feats.kp, config.fx, config.fy, config.cx, config.cy,
            config.k1, config.k2, config.p1, config.p2, config.k3,
        )
    else:
        kp = feats.kp
    return feats._replace(kp=kp, depth=d, valid=valid)


def _reset_lost(states: VOState, config: VOConfig) -> VOState:
    """Traced body of reset_lost_streams (shared with multistream_chunk)."""
    from lvt_tpu.core.state import LOST

    fresh = batched_initial_state(config, states.status.shape[0])
    lost = states.status == LOST

    def sel(new, old):
        cond = lost.reshape(lost.shape + (1,) * (old.ndim - 1))
        return jnp.where(cond, new, old)

    out = jax.tree.map(sel, fresh, states)
    # keep the last pose (world anchor shifts to it on re-init)
    return out._replace(pose=states.pose)


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def reset_lost_streams(states: VOState, config: VOConfig) -> VOState:
    """Per-stream auto-reset: any stream in LOST state is re-initialized in
    place (the batched analogue of the ROS shell's reset-on-lost policy,
    lvt_ros.cpp:241-254). The accumulated pose is preserved — matching
    m_reset_pose_on_lost_vo == false — so odometry continues from where
    tracking was lost."""
    return _reset_lost(states, config)


class MultiStreamVO:
    """Driver for a sharded batch of concurrent VO streams (stereo/RGB-D)."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None,
                 auto_reset: bool = True, rgbd: bool = False):
        config.validate()
        self.config = config
        self.n_streams = n_streams
        self.rgbd = rgbd
        if mesh is None:
            # use the largest device count that divides the stream batch
            devs = jax.devices()
            n_dev = len(devs)
            while n_streams % n_dev:
                n_dev -= 1
            mesh = mesh_mod.stream_mesh(devs[:n_dev])
        self.mesh = mesh
        self.auto_reset = auto_reset
        sharding = mesh_mod.stream_sharding(self.mesh)
        self.state_sharding = jax.tree.map(
            lambda _: sharding, batched_initial_state(config, n_streams)
        )
        self.states = self._put_state(
            batched_initial_state(config, n_streams), sharding
        )
        self.image_sharding = sharding
        # chunk batches are [N, S, H, W]: shard the stream axis (axis 1)
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.chunk_sharding = NamedSharding(
            self.mesh, P(None, mesh_mod.STREAM_AXIS)
        )

    def _put_state(self, state, sharding):
        """Place the initial batched state (overridden by the multi-host
        subclass, where device_put cannot address remote shards)."""
        return jax.device_put(state, sharding)

    def _put2(self, imgs1, imgs2, sharding):
        # dtype is preserved (uint8 uploads 4x less than float32; the jitted
        # step casts on device); device_put on an already-sharded device
        # array is a no-op, so callers can pre-upload outside timed regions
        a = jax.device_put(jnp.asarray(imgs1), sharding)
        b = jax.device_put(jnp.asarray(imgs2), sharding)
        return a, b

    def track(self, imgs1: np.ndarray, imgs2: np.ndarray):
        """One frame per stream. imgs: [S, H, W] — stereo (left, right) or
        RGB-D (grayscale, metric depth). Returns (poses: Pose[S], metrics)."""
        a, b = self._put2(imgs1, imgs2, self.image_sharding)
        step = multistream_step_rgbd if self.rgbd else multistream_step_stereo
        self.states, poses, metrics = step(self.states, a, b, self.config)
        if self.auto_reset:
            self.states = reset_lost_streams(self.states, self.config)
        return poses, metrics

    def track_chunk(self, imgs1: np.ndarray, imgs2: np.ndarray):
        """N frames for every stream in ONE dispatch. imgs: [N, S, H, W].
        Returns (poses [N, S], metrics [N, S]). The production benchmark
        shape (BASELINE config 4): per-frame host dispatch disappears and
        per-stream auto-reset happens on device inside the scan."""
        a, b = self._put2(imgs1, imgs2, self.chunk_sharding)
        self.states, poses, metrics = multistream_chunk(
            self.states, a, b, self.config,
            auto_reset=self.auto_reset, rgbd=self.rgbd,
        )
        return poses, metrics

    @property
    def status(self) -> np.ndarray:
        return np.asarray(self.states.status)
