"""BRIEF-256 binary descriptors, bit-packed for Hamming matmuls.

Replacement for OpenCV's ``xfeatures2d::BriefDescriptorExtractor``
(used by the reference at lvt/src/lvt_image_features_handler.cpp:117,172):
a 9x9 box-smoothed intensity is sampled at 256 fixed point pairs inside a
48x48 patch around each keypoint; bit i = [S(p1_i) < S(p2_i)]. Descriptors
are packed as 8 x uint32 (see lvt_tpu.ops.hamming).

The OpenCV test pattern is a machine-generated table; we instead generate a
pattern tuned to dense evaluation: 256 comparison pairs drawn from a
**pool of 64 distinct sample points** (i.i.d. isotropic Gaussian with
sigma = patch/5 clipped to the patch, per the BRIEF paper's best variant
G II — Calonder et al., ECCV 2010). Sampling from a pool means a dense
evaluation needs only 64 shifted copies of the smoothed image instead of 512
(one per pair endpoint) — an 8x cut in the dominant data movement of the
perception stage — while the 256 pairwise comparisons of 64 Gaussian
samples retain ~log2(64!) ≈ 296 bits of ordering information (descriptor
quality is validated at trajectory level by tests/test_parity_oracle.py).
The pattern only needs to be *consistent across frames*, not identical to
OpenCV's; the reference oracle (tools/oracle) shares this pattern.

Keypoints closer than PATCH/2 + KERNEL/2 to the image border are invalidated,
mirroring OpenCV's runByImageBorder removal (we clear the validity mask
instead of shrinking arrays — fixed shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lvt_tpu.ops.patches import PATCH, PATCH_C0, PATCH_R0

PATCH_SIZE = 32   # ORB-sized patch (OpenCV BRIEF uses 48; smaller patch +
#                   box smoothing keeps discrimination and shrinks the
#                   perception stencil's halo from 28 to 20 rows)
KERNEL_SIZE = 9
N_BITS = 256
POOL_SIZE = 64    # distinct sample points shared by the 256 pairs
BORDER = PATCH_SIZE // 2 + KERNEL_SIZE // 2  # 20
_PATTERN_SEED = 0x5F3759DF


@functools.lru_cache(maxsize=1)
def sample_pool() -> np.ndarray:
    """[POOL_SIZE, 2] int32 (dx, dy) distinct sample offsets."""
    rs = np.random.RandomState(_PATTERN_SEED)
    sigma = PATCH_SIZE / 5.0
    half = PATCH_SIZE // 2 - 1
    pts: list[tuple[int, int]] = []
    seen = set()
    while len(pts) < POOL_SIZE:
        cand = np.clip(np.round(rs.randn(2) * sigma), -half, half).astype(int)
        key = (int(cand[0]), int(cand[1]))
        if key not in seen:  # pool points must be distinct
            seen.add(key)
            pts.append(key)
    return np.array(pts, np.int32)


@functools.lru_cache(maxsize=1)
def pair_indices() -> np.ndarray:
    """[N_BITS, 2] int32 (i, j) pool indices; bit = S(p_i) < S(p_j)."""
    rs = np.random.RandomState(_PATTERN_SEED ^ 0xA5A5A5)
    pairs: list[tuple[int, int]] = []
    seen = set()
    while len(pairs) < N_BITS:
        i, j = rs.randint(0, POOL_SIZE, 2)
        if i != j and (i, j) not in seen and (j, i) not in seen:
            seen.add((i, j))
            pairs.append((int(i), int(j)))
    return np.array(pairs, np.int32)


@functools.lru_cache(maxsize=1)
def test_pattern() -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (dx, dy)) sampling offsets — the
    pair-expanded view of (sample_pool, pair_indices), kept as the stable
    interface for per-keypoint sampling (oracle, tests)."""
    return sample_pool()[pair_indices()]


def box_smooth(img: jnp.ndarray, size: int = KERNEL_SIZE) -> jnp.ndarray:
    """Separable box *sum* over a size x size window (edge-replicated),
    the analogue of OpenCV BRIEF's integral-image smoothedSum."""
    img = img.astype(jnp.float32)
    r = size // 2

    def along(a, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r + 1, r)
        ap = jnp.pad(a, pad, mode="edge")
        c = jnp.cumsum(ap, axis=axis)
        hi = jax.lax.slice_in_dim(c, size, size + a.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, a.shape[axis], axis=axis)
        return hi - lo

    return along(along(img, 0), 1)


_HALF = PATCH_SIZE // 2 - 1  # pattern offsets live in [-15, 15]


def dense_descriptor_planes(smooth: jnp.ndarray) -> jnp.ndarray:
    """Packed BRIEF bit-planes for EVERY pixel: [8, H, W] uint32.

    The 64 pool samples are materialized ONCE as statically-shifted copies
    of the smoothed image; the 256 pair comparisons then index into that
    pool and 32 comparisons OR-pack into one uint32 plane. Static shifts
    fuse into one stencil, so the per-keypoint descriptor afterwards is a
    tiny 8-word gather instead of 512 scalar gathers per keypoint."""
    h, w = smooth.shape
    pad = _HALF + 1
    sp = jnp.pad(smooth, pad)
    pool = sample_pool()      # [64, 2] numpy, static
    pairs = pair_indices()    # [256, 2] numpy, static

    def shifted(dx: int, dy: int):
        return jax.lax.slice(sp, (pad + dy, pad + dx), (pad + dy + h, pad + dx + w))

    samples = [shifted(int(dx), int(dy)) for dx, dy in pool]
    planes = []
    for word in range(8):
        acc = jnp.zeros((h, w), jnp.uint32)
        for i in range(32):
            pi, pj = pairs[word * 32 + i]
            bit = samples[pi] < samples[pj]
            acc = acc | (bit.astype(jnp.uint32) << np.uint32(i))
        planes.append(acc)
    return jnp.stack(planes)


def descriptors_sparse(
    smooth: jnp.ndarray,    # [H, W] float32 box-smoothed image
    kp: jnp.ndarray,        # [K, 2] float32 (x, y)
    kp_valid: jnp.ndarray,  # [K] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-keypoint BRIEF from the smoothed image with ONE flat gather.

    Bit-identical to gathering ``dense_descriptor_planes`` at the keypoints
    (same float comparisons on the same smoothed values): K*64 sample reads
    instead of 256 comparisons for every pixel (descriptor_mode
    "sparse")."""
    h, w = smooth.shape
    x = jnp.round(kp[:, 0]).astype(jnp.int32)
    y = jnp.round(kp[:, 1]).astype(jnp.int32)
    inside = (
        (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    )
    valid = kp_valid & inside
    # clamp so even masked-out keypoints index in-bounds (offsets reach ±15)
    xc = jnp.clip(x, _HALF + 1, w - _HALF - 2)
    yc = jnp.clip(y, _HALF + 1, h - _HALF - 2)
    pool = sample_pool()                      # [64, 2] static (dx, dy)
    idx = ((yc[:, None] + pool[None, :, 1]) * w
           + (xc[:, None] + pool[None, :, 0]))         # [K, 64]
    vals = jnp.take(smooth.reshape(-1), idx.reshape(-1), axis=0,
                    unique_indices=False).reshape(idx.shape)  # [K, 64]
    pairs = pair_indices()                    # [256, 2] static
    bits = vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]  # [K, 256]
    packed = bits.reshape(-1, 8, 32).astype(jnp.uint32) << jnp.arange(
        32, dtype=jnp.uint32
    )
    desc = packed.sum(axis=-1, dtype=jnp.uint32)        # [K, 8] (bits disjoint)
    return jnp.where(valid[:, None], desc, jnp.uint32(0)), valid


@functools.lru_cache(maxsize=1)
def _pool_onehot() -> np.ndarray:
    """[PATCH*PATCH, POOL_SIZE] f32 one-hot sampling matrix: column s
    selects patch pixel (PATCH_R0 + dy_s, PATCH_C0 + dx_s)."""
    m = np.zeros((PATCH * PATCH, POOL_SIZE), np.float32)
    for s, (dx, dy) in enumerate(sample_pool()):
        m[(PATCH_R0 + int(dy)) * PATCH + (PATCH_C0 + int(dx)), s] = 1.0
    return m


@functools.lru_cache(maxsize=1)
def _pair_onehots() -> tuple[np.ndarray, np.ndarray]:
    """Two [POOL_SIZE, N_BITS] f32 one-hots: g0 (g1) replicates the first
    (second) endpoint of each comparison pair across the 256 bit columns."""
    pairs = pair_indices()
    g0 = np.zeros((POOL_SIZE, N_BITS), np.float32)
    g1 = np.zeros((POOL_SIZE, N_BITS), np.float32)
    g0[pairs[:, 0], np.arange(N_BITS)] = 1.0
    g1[pairs[:, 1], np.arange(N_BITS)] = 1.0
    return g0, g1


def descriptors_from_patches(
    patches: jnp.ndarray,   # [K, PATCH, PATCH] f32 smooth patches
    x: jnp.ndarray,         # [K] int32 original (unclamped) keypoint column
    y: jnp.ndarray,         # [K] int32 ... row
    kp_valid: jnp.ndarray,  # [K] bool
    img_h: int,
    img_w: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """BRIEF-256 from per-keypoint smooth patches (ops/patches) as dense
    linear algebra: pool sampling and pair-endpoint replication are static
    one-hot matmuls instead of scattered gathers.

    Evaluated at ``Precision.HIGHEST`` the one-hot contractions are
    *bit-exact* f32 (each output accumulates exactly one value's bf16
    expansion; the partial sums have disjoint mantissa ranges), so the
    comparisons — and therefore the descriptors — are bit-identical to
    ``descriptors_sparse`` / dense-planes-at-keypoints."""
    k = patches.shape[0]
    hi = jax.lax.Precision.HIGHEST
    vals = jnp.dot(patches.reshape(k, -1), _pool_onehot(),
                   precision=hi)                               # [K, 64]
    g0, g1 = _pair_onehots()
    bits = jnp.dot(vals, g0, precision=hi) < jnp.dot(vals, g1, precision=hi)
    packed = bits.reshape(-1, 8, 32).astype(jnp.uint32) << jnp.arange(
        32, dtype=jnp.uint32
    )
    desc = packed.sum(axis=-1, dtype=jnp.uint32)               # [K, 8]
    inside = (
        (x >= BORDER) & (x < img_w - BORDER)
        & (y >= BORDER) & (y < img_h - BORDER)
    )
    valid = kp_valid & inside
    return jnp.where(valid[:, None], desc, jnp.uint32(0)), valid


def descriptors_from_planes(
    planes: jnp.ndarray,    # [8, H, W] uint32 packed bit-planes
    kp: jnp.ndarray,        # [K, 2] float32 (x, y)
    kp_valid: jnp.ndarray,  # [K] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather per-keypoint descriptors from precomputed dense bit-planes."""
    _, h, w = planes.shape
    x = jnp.round(kp[:, 0]).astype(jnp.int32)
    y = jnp.round(kp[:, 1]).astype(jnp.int32)
    inside = (
        (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    )
    valid = kp_valid & inside
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    desc = planes[:, yc, xc].T  # [K, 8] — one small gather
    return jnp.where(valid[:, None], desc, jnp.uint32(0)), valid


def descriptors_from_planes_flat(
    planes: jnp.ndarray,    # [8, H, W] uint32 packed bit-planes
    kp: jnp.ndarray,        # [K, 2] float32 (x, y)
    kp_valid: jnp.ndarray,  # [K] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """descriptors_from_planes via ONE flat jnp.take per word axis
    (gather_mode "flat"); bit-identical output."""
    _, h, w = planes.shape
    x = jnp.round(kp[:, 0]).astype(jnp.int32)
    y = jnp.round(kp[:, 1]).astype(jnp.int32)
    inside = (
        (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    )
    valid = kp_valid & inside
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    desc = jnp.take(planes.reshape(8, -1), yc * w + xc, axis=1).T  # [K, 8]
    return jnp.where(valid[:, None], desc, jnp.uint32(0)), valid


def descriptors_from_planes_slice8(
    planes: jnp.ndarray,    # [8, H, W] uint32 packed bit-planes
    kp: jnp.ndarray,        # [K, 2] float32 (x, y)
    kp_valid: jnp.ndarray,  # [K] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """descriptors_from_planes with a slice-shaped gather: the planes are
    interleaved to [H, W*8] so each keypoint's 8 words are CONTIGUOUS and
    one vmapped dynamic_slice per keypoint replaces the scattered
    8-element gather (gather_mode "slice"). Bit-identical output."""
    _, h, w = planes.shape
    x = jnp.round(kp[:, 0]).astype(jnp.int32)
    y = jnp.round(kp[:, 1]).astype(jnp.int32)
    inside = (
        (x >= BORDER) & (x < w - BORDER) & (y >= BORDER) & (y < h - BORDER)
    )
    valid = kp_valid & inside
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    pi = planes.transpose(1, 2, 0).reshape(h, w * 8)
    desc = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(pi, (yy, 8 * xx), (1, 8))[0]
    )(yc, xc)                                            # [K, 8]
    return jnp.where(valid[:, None], desc, jnp.uint32(0)), valid


@jax.jit
def compute_descriptors(
    img: jnp.ndarray,       # [H, W] grayscale
    kp: jnp.ndarray,        # [K, 2] float32 (x, y)
    kp_valid: jnp.ndarray,  # [K] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (desc [K, 8] uint32, valid [K] bool with border removal)."""
    return descriptors_sparse(box_smooth(img), kp, kp_valid)
