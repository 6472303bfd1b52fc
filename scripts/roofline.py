"""Roofline grounding for the headline benchmark.

Compiles the exact bench.py program (chunked single-stream track step at
KITTI geometry), pulls FLOPs and bytes accessed from XLA's cost analysis,
and prints

    bytes/frame, flops/frame, memory-bound ms, compute-bound ms,
    roofline ms, measured ms (optional timed run), headroom = measured /
    roofline

against the published peaks of the device it runs on (PEAKS, keyed by
``device_kind``; a device missing from the table is an error).

Usage:
    python scripts/roofline.py [--time]

Cost-analysis caveat: XLA reports bytes accessed per instruction assuming no
cache reuse between fused computations, so the memory bound is an upper
estimate of device-memory traffic (L2 reuse between kernels is invisible).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CHUNK = 16

# Published peaks per device_kind: NVIDIA H100 data sheet, SXM part, dense
# rates at the full 700 W power limit. The step's arithmetic is f32 outside
# the tensor cores (elementwise stencils, reductions, HIGHEST-precision
# solver contractions), so the compute bound uses the plain f32 rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_flops_s": 67e12},
}


def main() -> int:
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _kitti_config
    from lvt_tpu.core import step as step_mod
    from lvt_tpu import runtime
    from lvt_tpu.core.state import VOState

    dev = runtime.require_gpu()
    if dev["kind"] not in PEAKS:
        raise SystemExit(f"no published peaks for {dev['kind']!r}; add them "
                         "to PEAKS with their source")
    peak = PEAKS[dev["kind"]]
    config = _kitti_config()
    st = VOState.initial(config.max_map_points, config.max_staged_points,
                         config.local_ba_window)
    il = jnp.zeros((CHUNK, config.img_height, config.img_width), jnp.uint8)
    ir = jnp.zeros_like(il)

    fn = jax.jit(lambda s, a, b: step_mod.track_chunk_stereo(s, a, b, config))
    lowered = fn.lower(st, il, ir)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns one dict per device program
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    bytes_accessed = float(ca.get("bytes accessed", 0.0))

    per_frame_bytes = bytes_accessed / CHUNK
    per_frame_flops = flops / CHUNK
    t_mem_ms = per_frame_bytes / peak["bytes_s"] * 1e3
    t_flop_ms = per_frame_flops / peak["f32_flops_s"] * 1e3
    # traffic and compute overlap, so the floor is their max
    roof_ms = max(t_mem_ms, t_flop_ms)

    out = {
        "device": dev,
        "chunk": CHUNK,
        "img": [config.img_height, config.img_width],
        "bytes_per_frame": round(per_frame_bytes),
        "flops_per_frame": round(per_frame_flops),
        "memory_bound_ms": t_mem_ms,
        "compute_bound_ms": t_flop_ms,
        "roofline_ms": roof_ms,
        "bound_by": "memory" if t_mem_ms >= t_flop_ms else "compute",
    }

    if "--time" in sys.argv:
        st2, poses, _ = fn(st, il, ir)
        np.asarray(poses.t)  # value-readback anchor
        reps = 8
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, poses, _ = fn(st2, il, ir)
            np.asarray(poses.t)
            ts.append(time.perf_counter() - t0)
        measured_ms = min(ts) * 1e3 / CHUNK
        out["measured_ms_per_frame"] = measured_ms
        out["headroom_vs_roofline"] = measured_ms / roof_ms

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
