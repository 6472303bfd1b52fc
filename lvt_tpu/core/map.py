"""Local-map maintenance as masked fixed-shape array ops.

Re-design of the reference's std::vector surgery
(lvt/src/lvt_local_map.cpp): insertion becomes a masked scatter into free
slots, culling clears validity bits, staged-point promotion moves rows
between two fixed-capacity stores. No compaction, no reallocation — the
`valid` mask carries all liveness (SURVEY.md section 7 hard part #3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lvt_tpu.core.state import PointStore
from lvt_tpu.ops.collectives import por_if


class InsertResult(NamedTuple):
    store: PointStore
    n_inserted: jnp.ndarray
    n_dropped: jnp.ndarray  # overflow beyond capacity (reference never drops
    #                         — unbounded vectors; we surface it as a metric)
    taken: jnp.ndarray      # [capacity] bool: slots (re)populated this call


def insert_points(
    store: PointStore,
    new_pos: jnp.ndarray,      # [K, 3]
    new_desc: jnp.ndarray,     # [K, W]
    insert_mask: jnp.ndarray,  # [K] bool
    new_counter: jnp.ndarray | None = None,  # [K] int32, default 0
    new_age: jnp.ndarray | None = None,      # [K] int32, default 0
) -> InsertResult:
    """Scatter masked new points into free slots of the store.

    Free slots are filled in slot order with the masked new points in input
    order (compacted with a stable sort); overflow is dropped.
    """
    k = insert_mask.shape[0]
    if new_counter is None:
        new_counter = jnp.zeros((k,), jnp.int32)
    if new_age is None:
        new_age = jnp.zeros((k,), jnp.int32)

    # compact valid new points to the front (stable: keeps input order)
    order = jnp.argsort(jnp.logical_not(insert_mask), stable=True)
    pos_c = new_pos[order]
    desc_c = new_desc[order]
    ctr_c = new_counter[order]
    age_c = new_age[order]
    n_new = jnp.sum(insert_mask)

    free = jnp.logical_not(store.valid)
    free_rank = jnp.cumsum(free) - 1  # rank of each free slot
    take = free & (free_rank < n_new) & (free_rank < k)
    src = jnp.clip(free_rank, 0, k - 1)

    new_store = PointStore(
        pos=jnp.where(take[:, None], pos_c[src], store.pos),
        desc=jnp.where(take[:, None], desc_c[src], store.desc),
        counter=jnp.where(take, ctr_c[src], store.counter),
        age=jnp.where(take, age_c[src], store.age),
        valid=store.valid | take,
    )
    n_inserted = jnp.sum(take)
    return InsertResult(new_store, n_inserted, n_new - n_inserted, take)


def apply_match_bookkeeping(
    store: PointStore,
    match_idx: jnp.ndarray,  # [M] feature index, -1 unmatched, -2 invisible
) -> PointStore:
    """Post-matching counter/age updates (lvt_local_map.cpp:201-224):
    invisible or visible-but-unmatched -> counter += 1; matched -> age += 1."""
    failed = store.valid & (match_idx < 0)
    matched = store.valid & (match_idx >= 0)
    return store._replace(
        counter=store.counter + failed.astype(jnp.int32),
        age=store.age + matched.astype(jnp.int32),
    )


def clean_untracked(
    store: PointStore,
    match_idx: jnp.ndarray,       # [M] current-frame feature match per point
    feature_matched: jnp.ndarray,  # [K] bool
    untracked_threshold: int,
    axis_name: str | None = None,
) -> tuple[PointStore, jnp.ndarray]:
    """Drop points with counter >= threshold; un-mark their matched image
    feature so it becomes available for triangulation
    (lvt_local_map.cpp:393-413). Returns (store, updated feature_matched).

    With ``axis_name`` (map sharded over a mesh axis), the un-mark mask is
    OR-reduced across shards so every shard sees the same feature marks."""
    k = feature_matched.shape[0]
    remove = store.valid & (store.counter >= untracked_threshold)
    unmark_src = remove & (match_idx >= 0)
    unmark = jnp.zeros((k + 1,), bool).at[
        jnp.where(unmark_src, match_idx, k)
    ].set(True)[:k]
    unmark = por_if(unmark, axis_name)
    return (
        store._replace(valid=store.valid & ~remove),
        feature_matched & ~unmark,
    )
