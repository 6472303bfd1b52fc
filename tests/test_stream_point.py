"""2-D stream x points mesh: S streams shard over
`stream` while each stream's map shards over `points`, in ONE shard_map.
Equivalence vs per-stream unsharded runs on the virtual 8-device mesh."""

import jax
import numpy as np
import pytest

from lvt_tpu.config import VOConfig
from lvt_tpu.core.state import TRACKING
from lvt_tpu.core.system import VOSystem
from lvt_tpu.io.synthetic import SyntheticWorld
from lvt_tpu.parallel import mesh as mesh_mod
from lvt_tpu.parallel.stream_point import StreamPointVO


def make_world(seed):
    return SyntheticWorld(width=256, height=192, fx=210.0, fy=210.0,
                          cx=128.0, cy=96.0, baseline=0.25, n_points=1200,
                          extent_x=30.0, extent_y=14.0, extent_z=60.0,
                          seed=seed)


def make_config(world):
    return VOConfig(
        fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
        baseline=world.baseline, img_width=world.width,
        img_height=world.height, detection_cell_size=96,
        max_keypoints_per_cell=48, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=90.0,
        max_map_points=1024, max_staged_points=1024,
    )


def divergent_sequences(n_frames, n_streams=2):
    """Per-stream DIFFERENT worlds/motions so equivalence also proves
    stream independence under the 2-D mesh."""
    worlds = [make_world(seed=100 + 7 * s) for s in range(n_streams)]
    speeds = [0.3 + 0.1 * s for s in range(n_streams)]
    seqs = [list(w.stereo_sequence(n_frames, speed=sp))
            for w, sp in zip(worlds, speeds)]
    cfg = make_config(worlds[0])
    il = np.stack([np.stack([seqs[s][f][0] for s in range(n_streams)])
                   for f in range(n_frames)])
    ir = np.stack([np.stack([seqs[s][f][1] for s in range(n_streams)])
                   for f in range(n_frames)])
    return cfg, seqs, il, ir


@pytest.fixture(scope="module")
def mesh24():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide the virtual 8-device mesh"
    return mesh_mod.stream_point_mesh(2, 4, devs)


def test_mesh_shape(mesh24):
    assert mesh24.shape == {"stream": 2, "points": 4}


@pytest.mark.slow
def test_2d_step_matches_unsharded_streams(mesh24):
    cfg, seqs, il, ir = divergent_sequences(6)
    spvo = StreamPointVO(cfg, 2, mesh=mesh24)
    refs = [VOSystem(cfg), VOSystem(cfg)]

    for f in range(il.shape[0]):
        poses, metrics = spvo.track(il[f], ir[f])
        for s, vo in enumerate(refs):
            p_ref = vo.track(il[f, s], ir[f, s])
            # tolerance is wider than test_sharded_stream's 3e-4: the 2-D
            # path extracts features from ONE [2S,H,W] perception batch,
            # which XLA fuses differently from the per-stream [2,H,W]
            # batch, perturbing corner scores at float level and letting
            # selection ties land differently; drift stays sub-mm over the
            # sequence
            np.testing.assert_allclose(
                np.asarray(poses.t[s]), np.asarray(p_ref.t), atol=2e-3,
                err_msg=f"frame {f} stream {s}")

    assert (spvo.status == TRACKING).all()
    sizes = spvo.map_sizes()
    for s, vo in enumerate(refs):
        assert abs(int(sizes[s]) - vo.map_size) <= 2


@pytest.mark.slow
def test_2d_chunk_matches_stepwise(mesh24):
    cfg, _, il, ir = divergent_sequences(6)
    a = StreamPointVO(cfg, 2, mesh=mesh24)
    b = StreamPointVO(cfg, 2, mesh=mesh24)

    poses_chunk, _ = a.track_chunk(il, ir)
    for f in range(il.shape[0]):
        poses_step, _ = b.track(il[f], ir[f])
    np.testing.assert_allclose(np.asarray(poses_chunk.t[-1]),
                               np.asarray(poses_step.t), atol=1e-5)
    np.testing.assert_array_equal(a.map_sizes(), b.map_sizes())


@pytest.mark.slow
def test_2d_more_streams_than_mesh_axis(mesh24):
    """S=4 streams on a stream=2 mesh axis: 2 local streams per device
    row, vmapped inside the shard."""
    cfg, seqs, il, ir = divergent_sequences(5, n_streams=4)
    spvo = StreamPointVO(cfg, 4, mesh=mesh24)
    poses = None
    for f in range(il.shape[0]):
        poses, _ = spvo.track(il[f], ir[f])
    assert (spvo.status == TRACKING).all()
    # each stream recovered its own (different) forward speed
    dz = np.asarray(poses.t)[:, 2]
    expected = np.array([(0.3 + 0.1 * s) * (il.shape[0] - 1)
                         for s in range(4)])
    np.testing.assert_allclose(dz, expected, atol=0.25)
