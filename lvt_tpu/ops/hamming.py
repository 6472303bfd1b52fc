"""Bit-packed binary descriptors and dense masked Hamming matching.

Replacement for the reference's OpenCV ``BFMatcher(NORM_HAMMING)``
masked 2-NN loops (lvt/src/lvt_image_features_struct.cpp:68-148). Instead of a
25px spatial hash + per-query masked knnMatch, we compute one dense Hamming
distance matrix (XOR + population count over 8 uint32 words = 256-bit BRIEF)
and apply candidate masks as +inf distances; the mask *is* the spatial filter.

Match-acceptance rules mirror the reference exactly:
  * >= 2 candidates: accept best iff d1/d2 < ratio_threshold
  * exactly 1 candidate: accept iff d1 <= absolute_threshold
  * 0 candidates: no match
(lvt_image_features_struct.cpp:104-120 for tracking, :140-147 for row match.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_WORDS = 8  # 256-bit BRIEF descriptors as 8 x uint32
BIG = jnp.float32(1.0e9)


def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray,
                   matmul: bool = False) -> jnp.ndarray:
    """Dense Hamming distance matrix between packed descriptors.

    a: [N, W] uint32, b: [K, W] uint32  ->  [N, K] int32.

    Default path: XOR + popcount, unrolled over the (static, small) word
    axis so XLA keeps a single [N, K] accumulator live instead of an
    [N, K, W] intermediate. With ``matmul`` the descriptors unpack to
    +-1 bfloat16 rows and the distance is one matrix product on the
    tensor cores: dot(s_a, s_b) = matches - mismatches = bits - 2*hamming,
    which is EXACT (every partial sum is an integer with |dot| <= 256 and
    the accumulation is f32; tests/test_hamming.py checks bit-identity)."""
    if matmul:
        n_bits = a.shape[1] * 32
        dot = jax.lax.dot_general(
            _unpack_pm1(a), _unpack_pm1(b),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return ((n_bits - dot) * 0.5).astype(jnp.int32)
    n, w = a.shape
    k = b.shape[0]
    d = jnp.zeros((n, k), jnp.int32)
    for i in range(w):
        x = a[:, i][:, None] ^ b[None, :, i]
        d = d + jax.lax.population_count(x).astype(jnp.int32)
    return d


def _unpack_pm1(desc: jnp.ndarray) -> jnp.ndarray:
    """[N, W] uint32 -> [N, 32*W] bfloat16 in {-1, +1} (bit order is
    irrelevant as long as both operands agree)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    flat = bits.reshape(desc.shape[0], desc.shape[1] * 32)
    return (flat.astype(jnp.bfloat16) * 2 - 1)


def masked_top2(
    dist: jnp.ndarray, cand_mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-row best/second distances among masked candidates.

    dist: [Q, K] float or int, cand_mask: [Q, K] bool.
    Returns (d1, d2, best_idx, n_cand) each [Q].

    Implemented as two min-reductions instead of lax.top_k — a k=2
    selection needs no sort; argmin + one-hot mask + second min.
    """
    d = jnp.where(cand_mask, dist.astype(jnp.float32), BIG)
    d1 = jnp.min(d, axis=-1)
    best = jnp.argmin(d, axis=-1)
    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    is_best = col == best[..., None]
    d2 = jnp.min(jnp.where(is_best, BIG, d), axis=-1)
    n_cand = jnp.sum(cand_mask, axis=-1)
    return d1, d2, best, n_cand


def masked_top2_int(
    dist: jnp.ndarray, cand_mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """masked_top2 for INTEGER distance matrices via packed keys.

    key = d * K + col is strictly ordered by (distance, column), so its
    min/second-min ARE the top-2 with jnp.argmin's first-index tie-breaking
    built in — two full-matrix reductions instead of masked_top2's
    min + argmin + one-hot + min chain (~2 fewer [Q, K] passes, which is
    what the matching stage is bound by). Semantics identical to
    masked_top2 (tested in tests/test_hamming.py). Bounds: Hamming
    distances <= 256 and K <= ~8e6 keep the key far inside int32.
    """
    q, k = dist.shape
    imax = jnp.iinfo(jnp.int32).max
    col = jax.lax.broadcasted_iota(jnp.int32, dist.shape, dist.ndim - 1)
    key = jnp.where(cand_mask, dist.astype(jnp.int32) * k + col, imax)
    k1 = jnp.min(key, axis=-1)
    k2 = jnp.min(jnp.where(key == k1[..., None], imax, key), axis=-1)
    has1 = k1 != imax
    has2 = k2 != imax
    d1 = jnp.where(has1, (k1 // k).astype(jnp.float32), BIG)
    d2 = jnp.where(has2, (k2 // k).astype(jnp.float32), BIG)
    best = jnp.where(has1, k1 % k, 0)
    n_cand = jnp.sum(cand_mask, axis=-1)
    return d1, d2, best, n_cand


def accept_matches(
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    best: jnp.ndarray,
    n_cand: jnp.ndarray,
    ratio_threshold,
    abs_threshold,
) -> jnp.ndarray:
    """Reference acceptance rule -> match index per query, -1 if rejected."""
    ok_ratio = (n_cand >= 2) & (d1 < ratio_threshold * d2)
    ok_single = (n_cand == 1) & (d1 <= abs_threshold)
    return jnp.where(ok_ratio | ok_single, best, -1)


def resolve_one_to_one(
    match_idx: jnp.ndarray, d1: jnp.ndarray, num_targets: int,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Make a tentative many-to-one matching one-to-one.

    The reference loops over queries sequentially, marking target features
    as matched so later queries cannot claim them (greedy in query order,
    lvt_local_map.cpp:149-171). The parallel equivalent: every target keeps
    only the query with the smallest descriptor distance (ties broken by
    query index); losers get -1. This is order-independent and never worse
    than greedy in match quality.

    match_idx: [Q] int32 in [-1, num_targets); d1: [Q] distances.
    Returns match_idx with conflict losers set to -1.

    With ``axis_name`` set (queries sharded over a mesh axis, e.g. map-point
    blocks in the sharded-map stream mode), the per-target minimum becomes a
    global `pmin` over the axis; tie-breaking uses the GLOBAL query index so
    the winner is identical on every shard.
    """
    q = match_idx.shape[0]
    valid = match_idx >= 0
    if axis_name is not None:
        n_shards = jax.lax.axis_size(axis_name)
        qid = jax.lax.axis_index(axis_name) * q + jnp.arange(q, dtype=jnp.int32)
        mult = n_shards * q + 1
    else:
        qid = jnp.arange(q, dtype=jnp.int32)
        mult = q + 1
    # unique ordering key: distance then query index (distances are <= 256)
    key = d1.astype(jnp.int32) * mult + qid
    key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)
    tgt = jnp.where(valid, match_idx, num_targets)
    best_key = jnp.full((num_targets + 1,), jnp.iinfo(jnp.int32).max, jnp.int32)
    best_key = best_key.at[tgt].min(key)
    if axis_name is not None:
        best_key = jax.lax.pmin(best_key, axis_name)
    won = valid & (best_key[tgt] == key)
    return jnp.where(won, match_idx, -1)
