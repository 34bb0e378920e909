"""HBM-resident sorted accumulation table.

Replaces the reference's host-side aggregation — the TBB concurrent hash
map plus 250 MB-line host arenas (KMerCounter.cpp:51-89, GPUHandler.h:44-47)
— with a device-resident append buffer of (key-lanes, count) records:

  * ``append``: each chunk's compacted partial table is written at the
    running offset (a fixed-size, static-shape write; empty tail slots
    carry count 0 and are ignored by later reduction).
  * ``consolidate``: when the buffer would overflow (or at the end), one
    sort_reduce over the whole buffer collapses duplicates and re-compacts
    to the front — the in-HBM analog of the reference's dormant spill-file
    merge epoch (KMerFileMergeHandler/KMerFileMerger, SURVEY.md §3.3).

The host tracks a conservative (worst-case) offset to decide *when* to
consolidate, so the steady-state chunk loop never synchronizes with the
device; only a consolidation reads back the true table size (one int32).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kmer_counter.ops.sortcount import sort_reduce


class CountTable(NamedTuple):
    """Device state: capacity-C record buffer + live offset (lane-major)."""

    lanes: jnp.ndarray  # [NL, C] uint32
    counts: jnp.ndarray  # [C] uint32
    offset: jnp.ndarray  # scalar int32: slots in use (upper bound)


def make_table(capacity: int, num_lanes: int) -> CountTable:
    return CountTable(
        lanes=jnp.zeros((num_lanes, capacity), dtype=jnp.uint32),
        counts=jnp.zeros((capacity,), dtype=jnp.uint32),
        offset=jnp.int32(0),
    )


@partial(jax.jit, donate_argnums=(0,))
def append(table: CountTable, chunk_lanes, chunk_counts, chunk_unique) -> CountTable:
    """Append a chunk's compacted table at the running offset.

    Invariant: buffer rows at or past ``offset`` always have count 0.  The
    write covers the chunk's full static shape [N, NL] — rows [0,
    chunk_unique) are new records, the rest are the chunk's zero-count tail,
    which re-zeroes the skipped-over region — so advancing the offset by
    only ``chunk_unique`` preserves the invariant with no wasted slots.

    The caller must guarantee offset + N <= capacity (the host tracks a
    worst-case offset bound and consolidates before this could overflow;
    ``jax.lax.dynamic_update_slice`` would otherwise silently clamp).
    """
    lanes = jax.lax.dynamic_update_slice(
        table.lanes, chunk_lanes, (jnp.int32(0), table.offset)
    )
    counts = jax.lax.dynamic_update_slice(table.counts, chunk_counts, (table.offset,))
    return CountTable(lanes, counts, table.offset + chunk_unique)


@partial(jax.jit, donate_argnums=(0,))
def consolidate(table: CountTable) -> CountTable:
    """Collapse duplicates across everything appended so far."""
    lanes, counts, num_unique = sort_reduce(table.lanes, table.counts)
    return CountTable(lanes, counts, num_unique)


@partial(jax.jit, static_argnames=("capacity",))
def grow(table: CountTable, capacity: int) -> CountTable:
    """Copy into a larger buffer (host-triggered when cardinality outgrows
    the current capacity and HBM still has room)."""
    NL, C = table.lanes.shape
    if capacity < C:
        raise ValueError("grow() cannot shrink the table")
    lanes = jnp.zeros((NL, capacity), dtype=jnp.uint32).at[:, :C].set(table.lanes)
    counts = jnp.zeros((capacity,), dtype=jnp.uint32).at[:C].set(table.counts)
    return CountTable(lanes, counts, table.offset)
