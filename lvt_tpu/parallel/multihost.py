"""Multi-host (multi-process) execution: config 4/5 across hosts.

The reference is a single process by construction (SURVEY.md scope notes);
this module is the framework's `jax.distributed` story:

  * :func:`initialize` wraps ``jax.distributed.initialize`` so every process
    joins one JAX runtime; afterwards ``jax.devices()`` is the GLOBAL device
    list and meshes span hosts.
  * :class:`MultiHostStreamVO` extends the config-4 driver so that each
    process feeds ONLY its host-local streams — ingest never crosses hosts;
    the stream axis of the mesh places whole streams on single devices, so
    tracking computation needs no cross-host collectives at all, and the
    only cross-host traffic is program dispatch + whatever the caller gathers.
  * per-process readback: ``local_stream_indices`` + ``local_poses`` return
    the slice of results this host owns (no implicit global transfer).

Validated end-to-end by ``scripts/multihost_dryrun.py``: 2 processes x 4
virtual CPU devices each, per-process ingest, trajectories asserted
identical to single-process runs, plus a cross-process psum (the sharded-BA
reduction) over the global mesh. It has not run on multiple GPU hosts:
there ``initialize()`` needs the coordinator address, process count and
process id passed explicitly.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from lvt_tpu.config import VOConfig
from lvt_tpu.parallel import mesh as mesh_mod
from lvt_tpu.parallel.multistream import MultiStreamVO


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the global JAX runtime. On CPU/GPU fleets pass every argument
    explicitly (coordinator = "host:port" of process 0)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_stream_indices(mesh, n_streams: int) -> np.ndarray:
    """Global stream indices whose device lives on THIS process, for a
    1-D `stream` mesh. Streams are laid out contiguously over the mesh's
    device order: device k owns streams [k*per, (k+1)*per)."""
    devs = list(np.asarray(mesh.devices).reshape(-1))
    per = n_streams // len(devs)
    assert per * len(devs) == n_streams
    pid = jax.process_index()
    out = []
    for k, d in enumerate(devs):
        if d.process_index == pid:
            out.extend(range(k * per, (k + 1) * per))
    return np.asarray(out, np.int64)


class MultiHostStreamVO(MultiStreamVO):
    """Config-4 driver where every process feeds only its local streams.

    `track`/`track_chunk` take arrays covering ONLY this process's streams
    (shape [S_local, H, W] / [N, S_local, H, W], ordered by
    `local_stream_indices`); results come back as global sharded arrays —
    use `local_poses` to read this host's slice."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None,
                 auto_reset: bool = True, rgbd: bool = False):
        if mesh is None:
            mesh = mesh_mod.stream_mesh(jax.devices())  # global devices
        super().__init__(config, n_streams, mesh=mesh,
                         auto_reset=auto_reset, rgbd=rgbd)
        self.local_streams = local_stream_indices(self.mesh, n_streams)

    def _put_state(self, state, sharding):
        # every process materializes the (identical) initial value for its
        # addressable shards only
        return jax.tree.map(
            lambda x: jax.make_array_from_callback(
                x.shape, sharding, lambda idx: np.asarray(x[idx])
            ),
            state,
        )

    def _put2(self, imgs1, imgs2, sharding):
        a = jax.make_array_from_process_local_data(
            sharding, np.asarray(imgs1))
        b = jax.make_array_from_process_local_data(
            sharding, np.asarray(imgs2))
        return a, b

    def local_poses(self, poses) -> tuple[np.ndarray, np.ndarray]:
        """(t, q) for this process's streams, stream-axis order matching
        `local_stream_indices`. Works on both [S] and [N, S] results."""
        return (_local_concat(poses.t, self.local_streams, self.n_streams),
                _local_concat(poses.q, self.local_streams, self.n_streams))


def _local_concat(arr: jax.Array, local_idx: np.ndarray,
                  n_streams: int) -> np.ndarray:
    """Assemble this process's stream slice from addressable shards, in
    ascending global stream order (== local_stream_indices order)."""
    stream_axis = 0 if arr.shape[0] == n_streams else 1
    pieces = {}
    for shard in arr.addressable_shards:
        idx = shard.index[stream_axis]
        pieces[idx.start or 0] = np.asarray(shard.data)
    starts = sorted(pieces)
    got = np.concatenate([pieces[s] for s in starts], axis=stream_axis)
    # the shard starts must cover exactly our local streams
    per = got.shape[stream_axis] // len(starts)
    covered = np.concatenate([np.arange(s, s + per) for s in starts])
    np.testing.assert_array_equal(covered, np.asarray(local_idx))
    return got
