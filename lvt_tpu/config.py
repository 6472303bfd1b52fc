"""Configuration for the VO pipeline.

Equivalent of the reference's ``lvt_parameters`` (lvt/src/lvt_parameters.h:29-64,
defaults lvt/src/lvt_parameters.cpp:29-52) with the compile-time constants of
``lvt_definitions.h:29-34`` promoted to config fields, plus the static
capacities (padded keypoint / map sizes) that fix all array shapes.

The config is a frozen (hashable) dataclass so it can be passed to ``jax.jit``
as a static argument: every field here is shape- or trace-constant.
YAML loading understands the subset of YAML, plain and in OpenCV's
``%YAML:1.0`` dialect, that the reference's config files use (e.g.
examples/kitti/vo_config.yaml), with no YAML library.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

# -- constants from the reference (lvt_definitions.h:29-34), promoted to
#    config fields below but kept as module defaults
REPROJECTION_TH2 = 5.991  # chi-square 95% upper bound, 2 DoF
N_MAP_POINTS_SOFT_CAP = 250
ROW_MATCHING_VERTICAL_SEARCH_RADIUS = 2
HASHING_CELL_SIZE = 25  # unused (dense masks replace the hash grid)
CORNERS_LOW_TH = 200
N_MATCHES_TH = 50

# sentinel for "infinitely many matches" in the triangulation-policy window
# (the reference uses INT_MAX in a deque; we keep arithmetic in float32)
MATCHES_WINDOW_INIT = 1.0e9


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Static configuration of a VO system instance."""

    # ---- camera (must be specified; stereo assumed undistorted + rectified)
    fx: float = 0.5
    fy: float = 0.5
    cx: float = 0.5
    cy: float = 0.5
    baseline: float = 0.0
    img_width: int = 0
    img_height: int = 0
    # distortion (RGB-D path only; stereo input is pre-rectified)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    # ---- matching / tracking knobs (reference defaults)
    near_plane_distance: float = 0.1
    far_plane_distance: float = 500.0
    triangulation_ratio_test_threshold: float = 0.60
    tracking_ratio_test_threshold: float = 0.80
    descriptor_matching_threshold: float = 30.0
    min_num_matches_for_tracking: int = 10
    tracking_radius: int = 25
    detection_cell_size: int = 250
    max_keypoints_per_cell: int = 150
    agast_threshold: int = 25
    untracked_threshold: int = 10
    staged_threshold: int = 2
    # 1 = decreasing matches, 2 = always triangulate, 3 = map size < 1000
    triangulation_policy: int = 1

    # ---- constants promoted from lvt_definitions.h
    reprojection_th2: float = REPROJECTION_TH2
    map_soft_cap: int = N_MAP_POINTS_SOFT_CAP
    row_matching_vertical_search_radius: int = ROW_MATCHING_VERTICAL_SEARCH_RADIUS
    corners_low_threshold: int = CORNERS_LOW_TH
    n_matches_threshold: int = N_MATCHES_TH

    # ---- static capacities (all shapes derive from these)
    max_map_points: int = 1024      # hard capacity of the local map SoA
    max_staged_points: int = 1024   # hard capacity of the staging buffer
    max_keypoints: int = 0          # 0 => derived from the detection grid

    # ---- local bundle adjustment (opt-in accuracy feature; the reference
    # has no structure refinement at all — motion-only BA with fixed points)
    local_ba_window: int = 0       # sliding-window size F (0 = disabled)
    local_ba_every: int = 4        # run BA every N tracked frames
    local_ba_iterations: int = 6   # LM iterations per refinement

    # Hamming distances as one +-1 bf16 matrix product instead of the
    # 8-word XOR+popcount reduction (both exact; ops/hamming.hamming_matrix).
    # In the full KITTI step on the H100 the product is faster with a
    # 4096-point map and level with 1024 (chip_smoke.py phase 7 prints the
    # A/B; CHANGES.md has it).
    hamming_matmul: bool = True
    # legacy BRIEF strategy toggle, kept for config compatibility:
    # use_dense_brief=False maps to descriptor_mode "sparse" when
    # descriptor_mode is unset
    use_dense_brief: bool = True
    # descriptor/subpixel formation strategy (None = auto):
    #   "dense"  — dense BRIEF bit-planes + per-keypoint gather (default)
    #   "patch"  — one 32x32 smooth patch per keypoint (ops/patches),
    #              descriptors via exact one-hot matmuls
    #   "sparse" — per-keypoint flat-take of the 64 pool samples
    # auto resolves: use_dense_brief=False -> "sparse", else "dense". All
    # modes produce bit-identical descriptors at valid keypoints.
    descriptor_mode: str | None = None
    # per-keypoint lookup lowering: "scatter" (advanced-indexing gathers,
    # default), "flat" (one flat jnp.take) or "slice" (vmapped contiguous
    # dynamic_slice); identical results. None = auto (scatter)
    gather_mode: str | None = None

    # ---- observability
    enable_logging: bool = False
    enable_metrics: bool = False

    # ------------------------------------------------------------------
    # derived static geometry
    # ------------------------------------------------------------------
    @property
    def num_cells_x(self) -> int:
        return 1 + (self.img_width - 1) // self.detection_cell_size

    @property
    def num_cells_y(self) -> int:
        return 1 + (self.img_height - 1) // self.detection_cell_size

    @property
    def num_cells(self) -> int:
        return self.num_cells_x * self.num_cells_y

    @property
    def kp_capacity(self) -> int:
        """Static padded keypoint count per frame (lane-aligned)."""
        if self.max_keypoints:
            return self.max_keypoints
        return max(128, _round_up(self.num_cells * self.max_keypoints_per_cell, 128))

    @property
    def cell_kp_capacity(self) -> int:
        return self.max_keypoints_per_cell

    def validate(self) -> "VOConfig":
        assert self.img_width > 0 and self.img_height > 0, "image size must be set"
        assert self.detection_cell_size > 0
        assert self.max_keypoints_per_cell > 0
        assert self.tracking_radius > 0
        assert self.agast_threshold > 0
        return self

    def replace(self, **kw: Any) -> "VOConfig":
        return dataclasses.replace(self, **kw)


_INT_FIELDS = {
    f.name
    for f in dataclasses.fields(VOConfig)
    if f.type in ("int", int)
}
_BOOL_FIELDS = {"enable_logging", "enable_metrics"}

# map legacy reference YAML keys to config fields where names differ
_KEY_ALIASES = {
    "enable_visualization": None,       # host-side concern; ignored
    "viewer_camera_size": None,
    "viewer_point_size": None,
    # present in reference YAMLs but ignored by its loader (compile-time
    # consts there); we *do* honor them:
    "hashing_cell_size": None,          # no hash grid in the dense design
    "row_matching_vertical_search_radius": "row_matching_vertical_search_radius",
}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str) -> Any:
    """One YAML scalar or flow list: null, bool, int, float, quoted or
    bare string, ``[a, b, ...]``."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] in "\"'" and tok[-1] == tok[0]:
        return tok[1:-1]
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    low = tok.lower()
    if low in ("", "~", "null"):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def parse_opencv_yaml(text: str) -> dict:
    """Parse the YAML subset of the shipped configs into a dict.

    Understood: ``key: value`` lines, nested by indentation; comments;
    directives such as OpenCV's ``%YAML:1.0`` and ``---``; the
    ``!!opencv-matrix`` tag of KITTI calib files (reference:
    examples/kitti/calib/00.yml); flow lists ``[a, b, ...]``, also across
    lines. Anything else raises ValueError.
    """
    entries: list[tuple[int, str]] = []
    pending: list | None = None   # a flow list still waiting for its "]"
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending[1] += " " + line.strip()
            if "]" in line:
                entries.append((pending[0], pending[1]))
                pending = None
            continue
        body = line.strip()
        if not body or body.startswith("%") or body == "---":
            continue
        indent = len(line) - len(line.lstrip())
        body = body.replace("!!opencv-matrix", "").rstrip()
        if "[" in body and "]" not in body:
            pending = [indent, body]
        else:
            entries.append((indent, body))
    if pending is not None:
        raise ValueError(f"unterminated flow list: {pending[1]!r}")

    root: dict = {}
    # (indent of the owning key, mapping its deeper lines fill)
    stack: list[tuple[int, dict]] = [(-1, root)]
    open_key: tuple[int, dict, str] | None = None  # "key:" with no value
    for indent, body in entries:
        key, sep, value = body.partition(":")
        key = key.strip()
        if not sep or not key:
            raise ValueError(f"not a 'key: value' line: {body!r}")
        if open_key is not None and indent > open_key[0]:
            child: dict = {}
            open_key[1][open_key[2]] = child
            stack.append((open_key[0], child))
        open_key = None
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value.strip():
            parent[key] = _scalar(value)
        else:
            parent[key] = None
            open_key = (indent, parent, key)
    return root


def load_config(path: str, **overrides: Any) -> VOConfig:
    """Load a VOConfig from a YAML file (reference-compatible keys)."""
    with open(path) as f:
        data = parse_opencv_yaml(f.read())
    kw: dict[str, Any] = {}
    valid = {f.name for f in dataclasses.fields(VOConfig)}
    for key, value in data.items():
        key = _KEY_ALIASES.get(key, key)
        if key is None or key not in valid or value is None:
            continue
        if key in _BOOL_FIELDS:
            value = bool(int(value))
        elif key in _INT_FIELDS:
            value = int(value)
        elif isinstance(value, (int, float)):
            value = float(value)
        kw[key] = value
    kw.update(overrides)
    return VOConfig(**kw)


def load_kitti_calib(path: str) -> dict:
    """Load a KITTI calib YAML (camera_matrix + baseline) into intrinsics."""
    with open(path) as f:
        data = parse_opencv_yaml(f.read())
    m = data["camera_matrix"]["data"]
    return {
        "fx": float(m[0]),
        "cx": float(m[2]),
        "fy": float(m[4]),
        "cy": float(m[5]),
        "baseline": float(data["baseline"]),
    }
