"""Multistream scaling probe: ms per scan-step vs stream count S.

Compares the vmapped multistream chunk against S x the single-stream chunk
cost to localize vmap pathologies. Perf tool.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 8


def timeit(fn, *args, n=5, warmup=1):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    from lvt_tpu import runtime

    runtime.require_gpu()   # times the device; never the CPU
    import __graft_entry__ as ge
    from lvt_tpu.core import step as step_mod
    from lvt_tpu.core.state import VOState
    from lvt_tpu.io.synthetic import SyntheticWorld
    from lvt_tpu.parallel.multistream import (
        batched_initial_state, multistream_chunk,
    )

    config = ge._kitti_config()
    world = SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    frames = list(world.stereo_sequence(CHUNK + 2, speed=0.9))
    il = jnp.asarray(np.stack([f[0] for f in frames]), jnp.float32)
    ir = jnp.asarray(np.stack([f[1] for f in frames]), jnp.float32)

    # single-stream baseline
    st = VOState.initial(config.max_map_points, config.max_staged_points,
                         config.local_ba_window)
    single = jax.jit(
        lambda s, a, b: step_mod.track_chunk_stereo(s, a, b, config))
    ms = timeit(single, st, il[:CHUNK], ir[:CHUNK])
    print(f"single-stream chunk:  {ms:8.2f} ms -> {ms / CHUNK:6.2f} ms/frame")

    for s_count in (1, 2, 4, 8):
        states = batched_initial_state(config, s_count)
        a = jnp.broadcast_to(il[:CHUNK, None], (CHUNK, s_count) + il.shape[1:])
        b = jnp.broadcast_to(ir[:CHUNK, None], (CHUNK, s_count) + ir.shape[1:])
        fn = jax.jit(lambda st, x, y: multistream_chunk(
            st, x, y, config, auto_reset=False, rgbd=False))
        ms = timeit(fn, states, a, b, n=3)
        per = ms / (CHUNK * s_count)
        print(f"multistream S={s_count}:    {ms:8.2f} ms -> {per:6.2f} "
              f"ms/stream-frame")


if __name__ == "__main__":
    main()
