"""Multi-host dry run: 2 processes x 4 virtual CPU devices. Validates that
the multi-process path actually EXECUTES:

  stage A  config-4 multistream DP across both processes — each process
           feeds only its 4 local streams (divergent worlds), and each
           process's recovered trajectories must match the SINGLE-process
           run of the same 8-stream batched program (computed first by a
           reference subprocess on a virtual 8-device mesh) to 1e-4;
  stage B  cross-process collective — the sharded-BA psum reduction
           (parallel/ba.solve_pnp_sharded) over the 8-device global mesh,
           whose [6,6] normal-equation psum crosses the process boundary
           (across hosts on a real cluster), checked against the single-device
           solve.

Run with no arguments: the script re-launches itself as the 2 workers and
reports PASS/FAIL as one JSON line. CI: tests/test_multihost.py.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
N_PROC = 2
LOCAL_DEVICES = 4
N_STREAMS = 8
N_FRAMES = 6
PORT = int(os.environ.get("LVT_COORD_PORT", "47631"))


def _make_setup():
    """Config + per-stream frame generator, shared by reference/workers."""
    from lvt_tpu.config import VOConfig
    from lvt_tpu.io.synthetic import SyntheticWorld

    def make_world(seed):
        return SyntheticWorld(width=256, height=192, fx=210.0, fy=210.0,
                              cx=128.0, cy=96.0, baseline=0.25,
                              n_points=1200, extent_x=30.0, extent_y=14.0,
                              extent_z=60.0, seed=seed)

    world0 = make_world(0)
    cfg = VOConfig(
        fx=world0.fx, fy=world0.fy, cx=world0.cx, cy=world0.cy,
        baseline=world0.baseline, img_width=world0.width,
        img_height=world0.height, detection_cell_size=96,
        max_keypoints_per_cell=48, agast_threshold=12,
        near_plane_distance=0.5, far_plane_distance=90.0,
        max_map_points=1024, max_staged_points=1024,
    )

    def stream_frames(gid):
        w = make_world(seed=100 + 17 * int(gid))
        return list(w.stereo_sequence(N_FRAMES, speed=0.25 + 0.05 * int(gid)))

    return cfg, stream_frames


def reference(out_path: str) -> None:
    """Single-process run of the SAME 8-stream batched program on a virtual
    8-device mesh; saves the final per-stream positions."""
    import numpy as np

    from lvt_tpu.parallel.multistream import MultiStreamVO

    cfg, stream_frames = _make_setup()
    seqs = {g: stream_frames(g) for g in range(N_STREAMS)}
    il = np.stack([
        np.stack([seqs[g][f][0] for g in range(N_STREAMS)]).astype(np.uint8)
        for f in range(N_FRAMES)
    ])
    ir = np.stack([
        np.stack([seqs[g][f][1] for g in range(N_STREAMS)]).astype(np.uint8)
        for f in range(N_FRAMES)
    ])
    vo = MultiStreamVO(cfg, N_STREAMS)
    poses, _ = vo.track_chunk(il, ir)
    np.savez(out_path, t=np.asarray(poses.t),
             status=np.asarray(vo.states.status))
    print(json.dumps({"reference": True, "ok": True}), flush=True)


def worker(process_id: int, ref_path: str) -> None:
    import numpy as np

    import jax

    # must run before importing lvt_tpu: some module-level jnp constants
    # would otherwise initialise the XLA backend first
    jax.distributed.initialize(f"127.0.0.1:{PORT}", N_PROC, process_id)

    from lvt_tpu.parallel import multihost
    assert jax.process_count() == N_PROC
    assert jax.device_count() == N_PROC * LOCAL_DEVICES
    assert len(jax.local_devices()) == LOCAL_DEVICES

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from lvt_tpu.core.state import TRACKING
    from lvt_tpu.parallel import ba, mesh as mesh_mod
    from lvt_tpu.geometry.se3 import Pose

    cfg, stream_frames = _make_setup()

    # ---- stage A: multistream DP, host-local ingest -------------------
    vo = multihost.MultiHostStreamVO(cfg, N_STREAMS)
    local = vo.local_streams
    assert len(local) == N_STREAMS // N_PROC

    # frames for OUR streams only
    seqs = {int(g): stream_frames(g) for g in local}
    il = np.stack([
        np.stack([seqs[int(g)][f][0] for g in local]).astype(np.uint8)
        for f in range(N_FRAMES)
    ])
    ir = np.stack([
        np.stack([seqs[int(g)][f][1] for g in local]).astype(np.uint8)
        for f in range(N_FRAMES)
    ])

    poses, metrics = vo.track_chunk(il, ir)
    t_local, q_local = vo.local_poses(poses)   # [N_FRAMES, S_local, ...]
    status = np.asarray(
        multihost._local_concat(vo.states.status, local, N_STREAMS))
    assert (status == TRACKING).all(), status

    # the single-process run of the SAME batched program must agree
    ref = np.load(ref_path)
    assert (ref["status"] == TRACKING).all()
    max_err = float(
        np.abs(t_local[-1] - ref["t"][-1][np.asarray(local)]).max())
    assert max_err < 1e-4, (
        f"trajectory divergence vs single-process run: {max_err}")

    # ---- stage B: cross-process psum (sharded-BA reduction) -----------
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()), (mesh_mod.POINT_AXIS,))
    m = 16 * jax.device_count()
    rs = np.random.RandomState(3)
    pts = rs.uniform(-5, 5, (m, 3)).astype(np.float32)
    pts[:, 2] += 20.0
    uv = np.stack(
        [60.0 * pts[:, 0] / pts[:, 2] + 48.0,
         60.0 * pts[:, 1] / pts[:, 2] + 32.0], -1
    ).astype(np.float32)
    w = np.ones((m,), np.float32)

    sharded = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(mesh_mod.POINT_AXIS))

    def put(x):
        return jax.make_array_from_callback(
            x.shape, sharded, lambda idx: x[idx])

    res = ba.solve_pnp_sharded(
        Pose.identity(), put(pts), put(uv), put(w), mesh,
        fx=60.0, fy=60.0, cx=48.0, cy=32.0,
    )
    from lvt_tpu.solver.pnp import solve_pnp

    ref = solve_pnp(Pose.identity(), jnp.asarray(pts), jnp.asarray(uv),
                    jnp.ones((m,), jnp.float32),
                    fx=60.0, fy=60.0, cx=48.0, cy=32.0)
    # the solved pose is replicated; read our local copy
    t_shard = np.asarray(res.pose.t.addressable_shards[0].data)
    err_b = float(np.abs(t_shard - np.asarray(ref.pose.t)).max())
    assert err_b < 1e-5, f"sharded-BA divergence {err_b}"

    multihost_utils.sync_global_devices("lvt_multihost_dryrun_done")
    print(json.dumps({
        "process": process_id, "ok": True,
        "local_streams": [int(g) for g in local],
        "stage_a_max_err_m": max_err, "stage_b_err_m": err_b,
    }), flush=True)


def _env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local_devices}"
    ).strip()
    return env


def launch(ref_path: str | None = None) -> int:
    import tempfile

    if ref_path is None:
        ref_path = os.path.join(tempfile.mkdtemp(prefix="lvt_mh_"),
                                "reference.npz")
    # 1) single-process reference of the same batched program (8 devices)
    ref = subprocess.run(
        [sys.executable, __file__, "--reference", ref_path],
        env=_env(N_PROC * LOCAL_DEVICES), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=900,
    )
    if ref.returncode != 0:
        sys.stderr.write(f"--- reference ---\n{ref.stdout}\n")
        print(json.dumps({"ok": False, "stage": "reference"}))
        return 1
    # 2) the 2-process run
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid), ref_path],
            env=_env(LOCAL_DEVICES), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(N_PROC)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    results = []
    for o in outs:
        for line in o.splitlines():
            if line.startswith("{"):
                results.append(json.loads(line))
    print(json.dumps({"ok": ok, "workers": results}))
    if not ok:
        for i, o in enumerate(outs):
            sys.stderr.write(f"--- worker {i} ---\n{o}\n")
    return 0 if ok else 1


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), sys.argv[i + 2])
    elif "--reference" in sys.argv:
        reference(sys.argv[sys.argv.index("--reference") + 1])
    else:
        sys.exit(launch())
