"""Python backend for the C ABI shared library (``liblvt_c.so``).

The reference ships a C-interface shared library around ``lvt_system``
(lvt/src/lvt_c.h:57-62, lvt/src/lvt_c.cpp:33-148): opaque handle, create
from a YAML config + sensor enum, track on raw ``unsigned char*`` grayscale
buffers returning R[3][3]/t[3], and a status query. This framework's
equivalent keeps that exact C surface (``lvt_tpu/native/lvt_c.cpp`` embeds
CPython and forwards here) so existing C/C++ integrations of the reference
can switch by relinking.

This module is the thin registry the native layer calls into: it wraps the
caller's raw buffers (passed as writable memoryviews) into numpy arrays
without copying, drives :class:`lvt_tpu.core.system.VOSystem`, and returns
plain float tuples the C layer can read without numpy's C API.
"""

from __future__ import annotations

import numpy as np

_systems: dict[int, object] = {}
_next_handle: int = 1

_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def create(config_path: str, sensor_type: int) -> int:
    """Create a VO system from a YAML config; returns an integer handle
    (0 on failure, mirroring lvt_c.cpp's NULL-on-exception contract)."""
    global _next_handle
    from lvt_tpu.config import load_config
    from lvt_tpu.core.system import SensorType, VOSystem

    config = load_config(config_path)
    vo = VOSystem.create(config, SensorType(sensor_type))
    handle = _next_handle
    _next_handle += 1
    _systems[handle] = vo
    return handle


def destroy(handle: int) -> None:
    _systems.pop(handle, None)


def _image(buf, n_rows: int, n_cols: int, dtype=np.uint8) -> np.ndarray:
    a = np.frombuffer(buf, dtype=dtype, count=n_rows * n_cols)
    return a.reshape(n_rows, n_cols)


def _pose_tuple(vo) -> tuple:
    from lvt_tpu.core.system import pose_to_numpy

    t, r = pose_to_numpy(vo.last_pose)
    return tuple(float(x) for x in r.reshape(-1)) + tuple(float(x) for x in t)


def track(handle: int, left, right, n_rows: int, n_cols: int) -> tuple:
    """One tracking step on raw grayscale buffers. Returns 12 floats:
    row-major R[3][3] followed by t[3] (lvt_c.cpp:63-88)."""
    vo = _systems[handle]
    img_l = _image(left, n_rows, n_cols)
    from lvt_tpu.core.system import SensorType

    if vo.sensor_type == SensorType.RGBD:
        # the reference C ABI types both buffers unsigned char; depth in the
        # RGB-D case is interpreted as 8-bit metric depth like cv::Mat
        # CV_8UC1 would be (lvt_c.cpp:69-70)
        img_r = _image(right, n_rows, n_cols).astype(np.float32)
    else:
        img_r = _image(right, n_rows, n_cols)
    vo.track(img_l, img_r)
    return _pose_tuple(vo)


def track_with_external_corners(
    handle: int, left, right, n_rows: int, n_cols: int,
    corners_left, n_corners_left: int, corners_right, n_corners_right: int,
) -> tuple:
    """Descriptors-only path with caller-supplied corners
    (lvt_c.cpp:90-134). Corner buffers are double[N][2]."""
    vo = _systems[handle]
    img_l = _image(left, n_rows, n_cols)
    img_r = _image(right, n_rows, n_cols)
    cl = np.frombuffer(corners_left, dtype=np.float64,
                       count=2 * n_corners_left).reshape(-1, 2)
    cr = np.frombuffer(corners_right, dtype=np.float64,
                       count=2 * n_corners_right).reshape(-1, 2)
    vo.track_with_external_corners(img_l, img_r, cl, cr)
    return _pose_tuple(vo)


def get_status(handle: int) -> int:
    """1 = not initialized, 2 = tracking, 3 = lost (lvt_c.h:62)."""
    vo = _systems.get(handle)
    if vo is None:
        return 0
    return int(vo.get_state())


def reset(handle: int) -> None:
    """Beyond the reference ABI: expose lvt_system::reset to C callers too
    (the reference only reaches reset through the ROS shell)."""
    vo = _systems.get(handle)
    if vo is not None:
        vo.reset()
