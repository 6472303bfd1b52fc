"""lvt_tpu — a visual odometry framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the LVT
("Lightweight Visual Tracking") reference system: real-time feature-based
stereo and RGB-D visual odometry against a rolling local map of 3D points,
with motion-only bundle adjustment for the pose.

Design principles (accelerator-first, not a port):
  * Fixed shapes everywhere: keypoints padded to a static capacity with
    validity masks; the local map is a fixed-capacity structure-of-arrays.
  * One jitted ``track_step(state, frame) -> (state, pose, metrics)`` is the
    unit of execution; host<->device traffic is frame-in / pose-out.
  * Dense masked Hamming-distance matrices replace the reference's spatial
    hash + sequential BFMatcher loops (the mask *is* the spatial filter).
  * A ~100-line JAX Levenberg-Marquardt solver on SE(3) replaces g2o.
  * Batch dimensions replace threads; `vmap` over concurrent camera streams
    and `jax.sharding.Mesh` + NamedSharding replace any distributed runtime.
"""

from lvt_tpu.config import VOConfig, load_config

__version__ = "0.1.0"

__all__ = [
    "VOConfig",
    "load_config",
    "VOSystem",
    "SensorType",
    "TrackingState",
    "__version__",
]


def __getattr__(name):
    # lazy: avoid importing jax-heavy modules for config-only use
    if name in ("VOSystem", "SensorType", "TrackingState"):
        from lvt_tpu.core import system

        return getattr(system, name)
    raise AttributeError(f"module 'lvt_tpu' has no attribute {name!r}")
