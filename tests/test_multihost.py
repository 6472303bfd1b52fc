"""Multi-host execution: 2 jax.distributed processes x
4 virtual CPU devices, host-local ingest, trajectories identical to the
single-process run, cross-process psum in the sharded-BA reduction.

The heavy lifting is scripts/multihost_dryrun.py (it must own the
interpreters: jax.distributed.initialize cannot run in an already-
initialised pytest process); this test runs it end-to-end."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_multihost_dryrun_end_to_end(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "multihost_dryrun.py")],
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "LVT_COORD_PORT": "47911",
             "HOME": str(tmp_path)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=850, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] is True
    workers = {w["process"]: w for w in result["workers"]}
    assert set(workers) == {0, 1}
    # each process owned a disjoint half of the streams
    assert workers[0]["local_streams"] == [0, 1, 2, 3]
    assert workers[1]["local_streams"] == [4, 5, 6, 7]
    for w in workers.values():
        assert w["stage_a_max_err_m"] < 1e-4
        assert w["stage_b_err_m"] < 1e-5


def test_local_stream_indices_single_process():
    """On a single-process mesh every stream is local, in mesh order."""
    import jax
    import numpy as np

    from lvt_tpu.parallel import mesh as mesh_mod, multihost

    mesh = mesh_mod.stream_mesh(jax.devices())
    idx = multihost.local_stream_indices(mesh, 16)
    np.testing.assert_array_equal(idx, np.arange(16))


def test_local_concat_reassembles_sharded_axis():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lvt_tpu.parallel import mesh as mesh_mod, multihost

    mesh = mesh_mod.stream_mesh(jax.devices())
    n = 8 * 3
    arr = jnp.arange(n * 2, dtype=jnp.float32).reshape(n, 2)
    sharded = jax.device_put(arr, NamedSharding(mesh, P("stream")))
    got = multihost._local_concat(sharded, np.arange(n), n)
    np.testing.assert_array_equal(got, np.asarray(arr))
    # leading-frame layout [N, S] (poses from track_chunk)
    arr2 = jnp.arange(4 * n, dtype=jnp.float32).reshape(4, n)
    sharded2 = jax.device_put(arr2, NamedSharding(mesh, P(None, "stream")))
    got2 = multihost._local_concat(sharded2, np.arange(n), n)
    np.testing.assert_array_equal(got2, np.asarray(arr2))
