"""Device-mesh helpers — the framework's "distributed backend".

The reference has no distributed runtime at all (SURVEY.md section 2: the only
parallelism is one std::thread). The answer to NCCL/MPI here is
`jax.sharding.Mesh` + NamedSharding with XLA collectives (NCCL on GPUs):
independent camera streams shard over the `stream` axis; within a stream,
map-point blocks shard over the `points` axis for the distributed-BA
reduction (lvt_tpu.parallel.ba).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "stream"
POINT_AXIS = "points"


def stream_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices: pure data parallelism over camera streams."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (STREAM_AXIS,))


def stream_point_mesh(n_stream: int, n_point: int, devices=None) -> Mesh:
    """2-D mesh: streams x map-point shards (for sharded-BA configs)."""
    devices = jax.devices() if devices is None else devices
    assert len(devices) >= n_stream * n_point
    grid = np.array(devices[: n_stream * n_point]).reshape(n_stream, n_point)
    return Mesh(grid, (STREAM_AXIS, POINT_AXIS))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (stream batch) axis; everything else replicated."""
    return NamedSharding(mesh, P(STREAM_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
