"""Corner detection: vectorized FAST-9/16 score map + per-cell top-k.

Data-parallel replacement for the reference's per-cell OpenCV AGAST detection +
greedy adaptive non-maximal suppression (lvt/src/lvt_image_features_handler.cpp:
95-169, ANMS :34-83). Design decisions (per SURVEY.md section 7):

* The sequential AGAST decision tree becomes a *data-parallel* segment test:
  all 16 ring pixels are materialized as shifted copies of the image and the
  ">= 9 contiguous brighter/darker" test is evaluated with log-step bit tricks
  on a uint32 ring mask — identical corner criterion (FAST/OAST 9-16 family),
  no branches.

* The corner *score* is the classic max-threshold definition: the largest t
  for which the pixel is still a corner == max over the 16 contiguous 9-arcs
  of the minimum |difference| within the arc. Because the score map is
  threshold-independent, the reference's "retry detection with halved AGAST
  threshold if < 200 corners" (lvt_image_features_handler.cpp:161-169)
  becomes a *reselection* against the same score map with `where` — no second
  detection pass.

* Greedy per-cell ANMS becomes per-cell top-k by score after 3x3 non-max
  suppression (selection differs slightly from ANMS; parity is judged at
  trajectory level, SURVEY.md hard part #2). Unlike the reference, which
  detects on cell sub-images and therefore loses corners within 3px of every
  cell boundary, detection here is global; only selection is per-cell.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (dx, dy), the FAST-9/16 ring, clockwise.
RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3


def _ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] stack of ring-shifted copies (roll; border masked later)."""
    shifted = [jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)) for dx, dy in RING_OFFSETS]
    return jnp.stack(shifted, axis=0)


def _circular_min9(d: jnp.ndarray) -> jnp.ndarray:
    """min over each circular window of 9 consecutive ring elements.

    d: [16, ...] -> out[i] = min(d[i], d[i+1], ..., d[i+8]) (mod 16),
    computed with log-step doubling (4 rolls instead of 8).
    """
    rot = lambda x, k: jnp.roll(x, -k, axis=0)
    a2 = jnp.minimum(d, rot(d, 1))
    a4 = jnp.minimum(a2, rot(a2, 2))
    a8 = jnp.minimum(a4, rot(a4, 4))
    return jnp.minimum(a8, rot(d, 8))


def fast_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """FAST-9/16 max-threshold score per pixel ([H, W] float32, 0 = no corner).

    score(p) = max(t) such that some 9-long contiguous arc of the 16-pixel
    ring is entirely brighter than p+t (or entirely darker than p-t).
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    ring = _ring_stack(img)
    d = ring - img[None, :, :]  # [16, H, W]

    # brightest arc: max over arcs of (min of d within arc); dark symmetric
    score_bright = jnp.max(_circular_min9(d), axis=0)
    score_dark = jnp.max(_circular_min9(-d), axis=0)
    score = jnp.maximum(score_bright, score_dark)
    score = jnp.maximum(score, 0.0)

    # zero out the 3px border where the ring wraps around
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (
        (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    )
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression, plateau-collapsing.

    Ties break lexicographically: a pixel survives only if it strictly
    beats its "earlier" neighbors (above / left) and is >= its "later"
    ones. A weak `>=` on both sides keeps EVERY pixel of an equal-score
    run — on repetitive structure (stripe/checker edges: constant FAST
    score along the whole edge) that floods the per-cell top-k with
    clustered, mutually ambiguous corners, which measurably degrades
    tracking (tex_stripes parity scenario). Collapsing each plateau to its
    first pixel approximates the spatial spreading the reference gets from
    ANMS (lvt_image_features_handler.cpp:34-83) with fixed-shape ops."""
    h, w = score.shape
    pad = jnp.pad(score, 1, constant_values=-jnp.inf)

    def neigh(dy, dx):
        return jax.lax.dynamic_slice(pad, (1 + dy, 1 + dx), (h, w))

    before = jnp.maximum(
        jnp.maximum(neigh(-1, -1), neigh(-1, 0)),
        jnp.maximum(neigh(-1, 1), neigh(0, -1)),
    )
    after = jnp.maximum(
        jnp.maximum(neigh(0, 1), neigh(1, -1)),
        jnp.maximum(neigh(1, 0), neigh(1, 1)),
    )
    return jnp.where((score > before) & (score >= after), score, 0.0)


class Detections(NamedTuple):
    kp: jnp.ndarray      # [K, 2] float32 (x, y), subpixel-refined
    score: jnp.ndarray   # [K] float32
    valid: jnp.ndarray   # [K] bool
    count: jnp.ndarray   # [] int32
    threshold_used: jnp.ndarray  # [] float32 (after the low-corner fallback)
    kp_int: jnp.ndarray  # [K, 2] int32 detected (pre-refinement) corner;
    #                      descriptor sampling anchors here, matching the
    #                      reference's integer AGAST corners (OpenCV BRIEF
    #                      samples at the rounded detected keypoint —
    #                      lvt_image_features_handler.cpp:171-175)


def _bitrev8(v: jnp.ndarray) -> jnp.ndarray:
    """Bit-reversal of the low 8 bits (vectorized, branch-free)."""
    v = v & 0xFF
    v = ((v & 0x55) << 1) | ((v >> 1) & 0x55)
    v = ((v & 0x33) << 2) | ((v >> 2) & 0x33)
    return ((v & 0x0F) << 4) | ((v >> 4) & 0x0F)


def _plateau_dither(h: int, w: int) -> jnp.ndarray:
    """[h, w] f32 position-derived tie-break in [0, 1) for plateau
    spreading: van der Corput bit-reversal per axis (y-primary), quantized
    to multiples of 2^-15 so ``score + dither`` is EXACT in f32 for
    integer scores < 512 (uint8 frames: FAST scores <= 255) and the
    original score is recovered bit-exactly by subtraction.

    Why: the plateau-collapsing NMS keeps one pixel per equal-score run,
    but on periodic structure (tex_stripes) whole columns of equal-score
    survivors remain and the per-cell top-k picks an arbitrary, clustered,
    frame-unstable subset — the r4 parity gap (RPE 1.23x oracle). Ranking
    ties by bit-reversed coordinates makes the subset deterministic and
    stratified across the cell — fixed-shape spiritual kin of the
    reference's greedy ANMS radius (lvt_image_features_handler.cpp:34-83)."""
    return _dither_at(jnp.arange(h, dtype=jnp.int32)[:, None],
                      jnp.arange(w, dtype=jnp.int32)[None, :])


def _dither_at(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """The _plateau_dither value at integer position(s) (y, x) — used to
    recover exact scores after selection without any gather."""
    key = _bitrev8(y) * 128 + (_bitrev8(x) >> 1)          # < 2^15
    return key.astype(jnp.float32) * jnp.float32(2.0 ** -15)


def _cell_geometry(h: int, w: int, cell_size: int) -> tuple[int, int, int, int]:
    """Per-axis effective cell sizes (a cell larger than the image collapses
    to the image extent so we never pad beyond it)."""
    s_x = min(cell_size, w)
    s_y = min(cell_size, h)
    ncx = -(-w // s_x)
    ncy = -(-h // s_y)
    return s_y, s_x, ncy, ncx


def _parab_offset(sm, s0, sp):
    """Parabolic 3-point peak offset in [-0.5, 0.5] (shared by every
    subpixel-refinement lowering so results stay bit-identical)."""
    denom = sm - 2.0 * s0 + sp
    off = 0.5 * (sm - sp) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
    return jnp.clip(jnp.where(jnp.abs(denom) < 1e-6, 0.0, off), -0.5, 0.5)


def subpixel_from_patches(rawp: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Subpixel refinement from per-keypoint raw-score patches
    (ops/patches: [..., K, 8, 8] with the corner at (3, 4)) —
    static slices instead of 5 scattered gathers; identical arithmetic to
    ``_subpixel_refine`` for every in-bounds corner."""
    sc = rawp[..., 3, 4]
    dx = _parab_offset(rawp[..., 3, 3], sc, rawp[..., 3, 5])
    dy = _parab_offset(rawp[..., 2, 4], sc, rawp[..., 4, 4])
    return x.astype(jnp.float32) + dx, y.astype(jnp.float32) + dy


def _subpixel_refine(score_raw: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Quadratic (parabola) interpolation of the corner position from the
    raw score map. The reference's AGAST corners are integer pixels; this is
    a deliberate accuracy improvement — sub-pixel observations sharpen both
    triangulated depth (disparities can be < 1px at range) and PnP."""
    h, w = score_raw.shape
    xc = jnp.clip(x, 1, w - 2)
    yc = jnp.clip(y, 1, h - 2)
    sc = score_raw[yc, xc]

    offset = _parab_offset

    dx = offset(score_raw[yc, xc - 1], sc, score_raw[yc, xc + 1])
    dy = offset(score_raw[yc - 1, xc], sc, score_raw[yc + 1, xc])
    return x.astype(jnp.float32) + dx, y.astype(jnp.float32) + dy


def _subpixel_refine_flat(score_raw: jnp.ndarray, x: jnp.ndarray,
                          y: jnp.ndarray):
    """_subpixel_refine with the 5 neighborhood reads fused into ONE flat
    jnp.take of [5K] indices (gather_mode "flat"); identical results."""
    h, w = score_raw.shape
    xc = jnp.clip(x, 1, w - 2)
    yc = jnp.clip(y, 1, h - 2)
    base = yc * w + xc
    idx = jnp.stack([base, base - 1, base + 1, base - w, base + w])  # [5, K]
    s = jnp.take(score_raw.reshape(-1), idx.reshape(-1),
                 axis=0).reshape(idx.shape)
    sc = s[0]

    offset = _parab_offset

    dx = offset(s[1], sc, s[2])
    dy = offset(s[3], sc, s[4])
    return x.astype(jnp.float32) + dx, y.astype(jnp.float32) + dy


def _subpixel_refine_slice(score_raw: jnp.ndarray, x: jnp.ndarray,
                           y: jnp.ndarray):
    """_subpixel_refine via ONE vmapped (3, 3) dynamic_slice per corner
    instead of 5 scattered K-element gathers (gather_mode "slice").
    Identical results."""
    h, w = score_raw.shape
    xc = jnp.clip(x, 1, w - 2)
    yc = jnp.clip(y, 1, h - 2)
    patch = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(score_raw, (yy - 1, xx - 1),
                                             (3, 3))
    )(yc, xc)                                   # [K, 3, 3]
    sc = patch[:, 1, 1]

    offset = _parab_offset

    dx = offset(patch[:, 1, 0], sc, patch[:, 1, 2])
    dy = offset(patch[:, 0, 1], sc, patch[:, 2, 1])
    return x.astype(jnp.float32) + dx, y.astype(jnp.float32) + dy


@functools.partial(
    jax.jit,
    static_argnames=("cell_size", "max_per_cell", "corners_low_threshold",
                     "subpixel"),
)
def detect_corners(
    img: jnp.ndarray,
    threshold,
    *,
    cell_size: int,
    max_per_cell: int,
    corners_low_threshold: int = 200,
    subpixel: bool = True,
) -> Detections:
    """Full detection: score map -> NMS -> adaptive threshold -> cell top-k."""
    score_raw = fast_score_map(img)
    score = nms3x3(score_raw)
    return select_corners(
        score_raw, score, threshold,
        cell_size=cell_size, max_per_cell=max_per_cell,
        corners_low_threshold=corners_low_threshold, subpixel=subpixel,
    )


def select_corners(
    score_raw: jnp.ndarray,
    score: jnp.ndarray,  # NMS'd score map
    threshold,
    *,
    cell_size: int,
    max_per_cell: int,
    corners_low_threshold: int = 200,
    subpixel: bool = True,
    gather_mode: str = "scatter",   # "scatter" | "flat" | "slice" (same result)
    spread_ties: bool = True,
) -> Detections:
    """Adaptive threshold + per-cell top-k selection from precomputed score
    maps.

    Output capacity is ncells * max_per_cell, cell-major then score-descending
    (matching the reference's concatenate-per-cell order,
    lvt_image_features_handler.cpp:131-154).
    """
    h, w = score.shape
    s_y, s_x, ncy, ncx = _cell_geometry(h, w, cell_size)

    # pad to the cell grid and reshape to [ncells, cellpix]; selection
    # ranks by score + plateau dither (see _plateau_dither) so equal-score
    # runs on repetitive structure come back stratified, not clustered —
    # the exact scores are recovered after selection by subtracting the
    # (position-determined) dither. ``spread_ties`` should be False for
    # NON-integer score maps (float frames, e.g. the fused-rectify path):
    # there the sub-1.0 dither would outrank genuine sub-unit score
    # differences instead of only breaking exact ties, and the post-hoc
    # subtraction is no longer an exact recovery.
    gy, gx = ncy * s_y, ncx * s_x
    sp = jnp.pad(score, ((0, gy - h), (0, gx - w)))
    if spread_ties:
        sp = sp + _plateau_dither(gy, gx)
    cells = sp.reshape(ncy, s_y, ncx, s_x).transpose(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, s_y * s_x)

    threshold = jnp.asarray(threshold, jnp.float32)

    # exact per-cell top-k. Selection is threshold-independent, so the
    # low-corner fallback counts what is SELECTED at the base threshold;
    # the halved retry threshold rounds like the reference's
    # int(t * 0.5 + 0.5) (lvt_image_features_handler.cpp:161-169).
    top_keys, flat_idx = jax.lax.top_k(cells, max_per_cell)

    cell_ids = jnp.arange(ncy * ncx)[:, None]
    cy = cell_ids // ncx
    cx = cell_ids % ncx
    y2 = cy * s_y + flat_idx // s_x
    x2 = cx * s_x + flat_idx % s_x
    # exact score recovery: the dither is a pure function of position, and
    # score + dither is exact in f32 for integer scores < 512 (uint8
    # frames), so threshold semantics are unchanged
    top_scores = (top_keys - _dither_at(y2, x2)) if spread_ties else top_keys
    y = y2.reshape(-1)
    x = x2.reshape(-1)

    t_low = jnp.floor(threshold * 0.5 + 0.5)
    use_low = jnp.sum(top_scores > threshold) < corners_low_threshold
    t_eff = jnp.where(use_low, t_low, threshold)
    valid = top_scores > t_eff

    xi = jnp.minimum(x, w - 1)
    yi = jnp.minimum(y, h - 1)
    if subpixel:
        refine = {"slice": _subpixel_refine_slice,
                  "flat": _subpixel_refine_flat}.get(gather_mode,
                                                     _subpixel_refine)
        xf, yf = refine(score_raw, xi, yi)
    else:
        xf, yf = xi.astype(jnp.float32), yi.astype(jnp.float32)
    kp = jnp.stack([xf, yf], axis=-1)
    score_out = top_scores.reshape(-1)
    valid = valid.reshape(-1)
    return Detections(
        kp=kp,
        score=score_out,
        valid=valid,
        count=jnp.sum(valid),
        threshold_used=t_eff,
        kp_int=jnp.stack([xi, yi], axis=-1).astype(jnp.int32),
    )
