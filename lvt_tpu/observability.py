"""Observability: per-frame metrics recording and trace logging.

Equivalent of the reference's ``lvt_value_recorder`` and ``lvt_log``
(lvt/src/lvt_logging_utils.cpp:44-150): the recorder writes one CSV row per
frame to ``measurments.txt`` with series names in ``titles.txt`` (identical
filenames/format for comparability, including the reference's spelling); the
logger writes ms-since-init-stamped lines to ``vo-<datetime>.txt``.

Because the jitted step returns a StepMetrics pytree of scalars, per-point
series (age, descriptor distances, feature x/y) are recorded as per-frame
means rather than one value per matched point — the aggregation divergence is
deliberate and documented (SURVEY.md section 5).

For kernel-level profiling use ``profile_trace`` (jax.profiler wrapper); the
pipeline stages carry ``jax.named_scope`` markers (core/step.py:
motion_predict / map_matching / pnp_solve / map_bookkeeping / staged_update /
triangulation / local_ba; core/extract.py: perception /
corner_select_describe) so traces attribute ops to the same stages the
reference's lvt_log brackets.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time

import numpy as np

# reference series names (lvt_system.cpp:339-349)
REFERENCE_SERIES = [
    "map points count",
    "staged points count",
    "image keypoints",
    "tracked map points",
    "age",
    "closest descriptor distance",
    "second descriptor distance",
    "img feature x",
    "img feature y",
    "inlier count",
]

_METRIC_FIELD_FOR_SERIES = {
    "map points count": "map_points_count",
    "staged points count": "staged_points_count",
    "image keypoints": "image_keypoints",
    "tracked map points": "tracked_map_points",
    "age": "mean_age",
    "closest descriptor distance": "mean_closest_descriptor_distance",
    "second descriptor distance": "mean_second_descriptor_distance",
    "img feature x": "mean_feature_x",
    "img feature y": "mean_feature_y",
    "inlier count": "inlier_count",
}


class ValueRecorder:
    """Per-frame named value series -> CSV (lvt_value_recorder equivalent)."""

    def __init__(self, out_dir: str = ".",
                 values_filename: str = "measurments.txt",
                 titles_filename: str = "titles.txt"):
        self.out_dir = out_dir
        self.values_path = os.path.join(out_dir, values_filename)
        self.titles_path = os.path.join(out_dir, titles_filename)
        self.series: list[str] = list(REFERENCE_SERIES)
        self.rows: list[list[float]] = []
        self._current: dict[str, float] = {}

    def register_value(self, name: str) -> None:
        if name not in self.series:
            self.series.append(name)

    def record(self, name: str, value) -> None:
        self._current[name] = float(value)

    def record_step(self, metrics) -> None:
        """Record a StepMetrics pytree as one frame."""
        for series, field in _METRIC_FIELD_FOR_SERIES.items():
            self.record(series, np.asarray(getattr(metrics, field)))
        self.flush_frame()

    def record_chunk(self, metrics) -> None:
        """Record a chunked StepMetrics pytree (leaves have a leading [N]
        frame axis) as N frames with ONE device->host transfer per series —
        NOT ~13 tiny per-frame slice ops × N (the overhead class the lazy
        last_metrics fix removed from the dispatch path).
        Equivalent per-row output to N record_step calls."""
        host = {
            series: np.asarray(getattr(metrics, field)).reshape(-1)
            for series, field in _METRIC_FIELD_FOR_SERIES.items()
        }
        n = len(next(iter(host.values())))
        extra = dict(self._current)  # values recorded via record() apply to
        self._current = {}           # every frame of the chunk
        for i in range(n):
            row = {s: float(v[i]) for s, v in host.items()}
            row.update(extra)
            self.rows.append([row.get(s, 0.0) for s in self.series])

    def flush_frame(self) -> None:
        self.rows.append([self._current.get(s, 0.0) for s in self.series])
        self._current = {}

    def finish(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.values_path, "w") as f:
            for row in self.rows:
                f.write(",".join(f"{v:g}" for v in row) + "\n")
        with open(self.titles_path, "w") as f:
            f.write("\n".join(self.series) + "\n")

    def reset(self) -> None:
        """Called when the VO system resets. The reference's recorder keeps
        one value stream per run across VO resets (lvt_logging_utils.cpp:
        103-150 — nothing clears m_values), so accumulated rows are KEPT;
        only the in-progress frame is discarded. (A finish()-then-clear
        here would make a later finish() overwrite the file with only
        post-reset rows.)"""
        self._current = {}


class TraceLog:
    """Timestamped trace log (lvt_log equivalent)."""

    def __init__(self, out_dir: str = ".", enabled: bool = True):
        self.enabled = enabled
        self._file = None
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
            self._file = open(os.path.join(out_dir, f"vo-{stamp}.txt"), "w")
            self._t0 = time.perf_counter()

    def log(self, message: str) -> None:
        if self._file is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._file.write(f"{ms:.3f} | {message}\n")

    def log_params(self, config) -> None:
        if self._file is not None:
            import dataclasses

            self.log("Parameters:")
            for f in dataclasses.fields(config):
                self.log(f"  {f.name} = {getattr(config, f.name)}")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/lvt_tpu_profile"):
    """jax.profiler trace around a region — the device-side replacement for
    the reference's wall-clock stage logs (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
