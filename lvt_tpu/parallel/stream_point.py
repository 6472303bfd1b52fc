"""2-D ``stream x points`` parallelism: many VO streams, each with a
mesh-sharded local map — the composition SCALING.md describes
(configs 4+5 at once).

Layout on a ``Mesh((stream=NS, points=NP))``:

  * every VOState leaf gains a leading stream axis sharded over ``stream``;
  * the point stores' point axis additionally shards over ``points``
    (each device holds S/NS streams x map/NP points);
  * images/features shard over ``stream`` only;
  * inside ONE ``shard_map`` over both axes, the per-device body vmaps the
    sharded-map tracking step over its local streams — the ``points``
    collectives (psum match counts, pmin one-to-one claims, psum'd PnP/BA
    normal equations; see parallel/sharded_stream.py) stay inside each
    stream's point group, and the stream axis needs no collectives at all
    (streams are independent).

Numerics match parallel/sharded_stream.ShardedStreamVO per stream, which
itself matches the unsharded step (tests/test_sharded_stream.py); the
reference is single-stream single-threaded C++ with no counterpart
(SURVEY.md §2 parallelism inventory items (a)+(c) composed).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lvt_tpu.config import VOConfig
from lvt_tpu.core import extract, step as step_mod
from lvt_tpu.core.state import VOState
from lvt_tpu.geometry.se3 import Pose
from lvt_tpu.parallel import multistream as ms
from lvt_tpu.parallel import mesh as mesh_mod
from lvt_tpu.parallel.sharded_stream import _metrics_specs, state_specs

STREAM_AXIS = mesh_mod.STREAM_AXIS
POINT_AXIS = mesh_mod.POINT_AXIS

shard_map = jax.shard_map


def batched_state_specs(stream_axis: str = STREAM_AXIS,
                        point_axis: str = POINT_AXIS) -> VOState:
    """PartitionSpecs for a stream-batched VOState whose point stores also
    shard over the point axis (leaf shapes [S, N, ...] -> P(stream, points,
    ...); replicated-per-stream leaves -> P(stream))."""
    return jax.tree.map(lambda spec: P(stream_axis, *spec),
                        state_specs(point_axis))


def _vmapped_body(config: VOConfig, rgbd: bool):
    def body(st, left, right):
        return jax.vmap(
            lambda s1, l, r: step_mod.track_features(
                s1, l, r, config, rgbd=rgbd, axis_name=POINT_AXIS
            )
        )(st, left, right)

    return body


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def stream_point_step_stereo(
    states: VOState,          # batched [S, ...], point stores [S, N, ...]
    imgs_left: jnp.ndarray,   # [S, H, W]
    imgs_right: jnp.ndarray,  # [S, H, W]
    config: VOConfig, mesh,
):
    """One frame for every stream on the 2-D mesh."""
    s = imgs_left.shape[0]
    feats = extract.extract_features_batched(
        jnp.concatenate([imgs_left, imgs_right]), config
    )
    left = jax.tree.map(lambda a: a[:s], feats)
    right = jax.tree.map(lambda a: a[s:], feats)
    specs = batched_state_specs()
    feat_specs = jax.tree.map(lambda _: P(STREAM_AXIS), left)
    fn = shard_map(
        _vmapped_body(config, rgbd=False),
        mesh=mesh,
        in_specs=(specs, feat_specs, feat_specs),
        out_specs=(specs, Pose(P(STREAM_AXIS), P(STREAM_AXIS)),
                   jax.tree.map(lambda _: P(STREAM_AXIS), _metrics_specs())),
        check_vma=False,
    )
    return fn(states, left, right)


@functools.partial(jax.jit,
                   static_argnames=("config", "mesh", "auto_reset"),
                   donate_argnums=(0,))
def stream_point_chunk_stereo(
    states: VOState,
    imgs1: jnp.ndarray,       # [N, S, H, W]
    imgs2: jnp.ndarray,       # [N, S, H, W]
    config: VOConfig, mesh, auto_reset: bool = True,
):
    """Chunked 2-D tracking: scan N frames of the S-stream batch in ONE
    dispatch, each stream's map sharded over `points`. Per-stream
    auto-reset runs inside the scan like multistream_chunk."""
    specs = batched_state_specs()

    def body(st, frame):
        a, b = frame
        s = a.shape[0]
        feats = extract.extract_features_batched(
            jnp.concatenate([a, b]), config
        )
        left = jax.tree.map(lambda x: x[:s], feats)
        right = jax.tree.map(lambda x: x[s:], feats)
        feat_specs = jax.tree.map(lambda _: P(STREAM_AXIS), left)
        st2, poses, metrics = shard_map(
            _vmapped_body(config, rgbd=False),
            mesh=mesh,
            in_specs=(specs, feat_specs, feat_specs),
            out_specs=(specs, Pose(P(STREAM_AXIS), P(STREAM_AXIS)),
                       jax.tree.map(lambda _: P(STREAM_AXIS),
                                    _metrics_specs())),
            check_vma=False,
        )(st, left, right)
        if auto_reset:
            st2 = ms._reset_lost(st2, config)
        return st2, (poses, metrics)

    states, (poses, metrics) = jax.lax.scan(body, states, (imgs1, imgs2))
    return states, poses, metrics


class StreamPointVO:
    """Driver for S streams x point-sharded maps on a 2-D device mesh."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None,
                 auto_reset: bool = True):
        config.validate()
        self.config = config
        self.n_streams = n_streams
        self.auto_reset = auto_reset
        if mesh is None:
            devs = jax.devices()
            ns = max(d for d in range(1, len(devs) + 1)
                     if n_streams % d == 0 and len(devs) % d == 0)
            mesh = mesh_mod.stream_point_mesh(ns, len(devs) // ns, devs)
        self.mesh = mesh
        ns = mesh.shape[STREAM_AXIS]
        npnt = mesh.shape[POINT_AXIS]
        assert n_streams % ns == 0, (n_streams, ns)
        assert config.max_map_points % npnt == 0
        assert config.max_staged_points % npnt == 0

        specs = batched_state_specs()
        init = ms.batched_initial_state(config, n_streams)
        self.states = jax.device_put(
            init, jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs)
        )
        self.image_sharding = NamedSharding(mesh, P(STREAM_AXIS))
        self.chunk_sharding = NamedSharding(mesh, P(None, STREAM_AXIS))

    def track(self, imgs_left, imgs_right):
        a = jax.device_put(jnp.asarray(imgs_left), self.image_sharding)
        b = jax.device_put(jnp.asarray(imgs_right), self.image_sharding)
        self.states, poses, metrics = stream_point_step_stereo(
            self.states, a, b, self.config, self.mesh
        )
        if self.auto_reset:
            self.states = ms.reset_lost_streams(self.states, self.config)
        return poses, metrics

    def track_chunk(self, imgs1, imgs2):
        a = jax.device_put(jnp.asarray(imgs1), self.chunk_sharding)
        b = jax.device_put(jnp.asarray(imgs2), self.chunk_sharding)
        self.states, poses, metrics = stream_point_chunk_stereo(
            self.states, a, b, self.config, self.mesh,
            auto_reset=self.auto_reset,
        )
        return poses, metrics

    @property
    def status(self) -> np.ndarray:
        return np.asarray(self.states.status)

    def map_sizes(self) -> np.ndarray:
        return np.asarray(self.states.map.size())
