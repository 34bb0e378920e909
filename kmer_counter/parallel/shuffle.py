"""Prefix-routed all-to-all merge of per-device partial count tables.

This is the on-device replacement for the reference's entire external-memory
merge subsystem — the spill writer (FileDump.cpp:51-58), the background
merge scheduler (KMerFileMergeHandler.cpp:49-100), the linear-scan k-way
merger (KMerFileMerger.cpp:49-96) and the sorted-run reader
(SortedKMerFile.cpp:57-82).  Where the reference shuttles sorted runs
through the filesystem and merges them on host threads, every record here
makes exactly one ICI/DCN hop to the device that owns its key range, and
each owner collapses its range with one sort-reduce in HBM.

Routing function (two modes, both monotonic range partitions of the
uint32 lead lane, so device d's range table is entirely smaller than
device d+1's and the global dump is the per-device tables concatenated in
mesh order, already sorted — the property the reference's merge tree
worked so hard for on disk):

  * uniform: ``owner(key) = (lane0>>16) * D >> 16`` — splits the key
    space evenly.  Simple, but canonical keys are min(fwd, revcomp) and
    hence systematically biased toward the low half of the space, leaving
    high-rank devices under-loaded (VERDICT r4 item 4).
  * sampled splitters (default): each device contributes S evenly-spaced
    lead-lane samples from its sorted live prefix; one tiny all_gather
    pools them, and the D-1 quantiles of the pooled sample become the
    range boundaries — classic sample-sort regular sampling, adapted to
    whatever key distribution the input actually has.  Every device
    computes identical splitters (the gather is deterministic), so the
    partition stays consistent mesh-wide.

All functions here run *inside* ``shard_map`` over the 1-D ``data`` mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kmer_counter.ops.sortcount import sort_reduce

SPLITTER_SAMPLES = 64  # per-device sample count for regular sampling


def owner_of(lane0: jnp.ndarray, num_devices: int) -> jnp.ndarray:
    """Monotonic range-partition of the uint32 lead lane into D owners."""
    return ((lane0 >> jnp.uint32(16)).astype(jnp.int32) * num_devices) >> 16


def sampled_splitters_host(
    mesh,
    lanes,
    counts,
    block: int,
    num_devices: int,
    samples: int = SPLITTER_SAMPLES,
):
    """[D-1] uint32 range boundaries from pooled per-device samples,
    computed host-side (tiny, once per run — the counters freeze the
    result; see route_merge_local's contract).

    Requires the table contract shared by sort_reduce and consolidate2:
    live rows (count > 0) are dense at the front and sorted ascending.
    Each device contributes ``samples`` evenly-spaced lead-lane values
    from its live prefix (max-value fill when empty, parking at the top
    of the pooled sort); the pooled quantiles are the boundaries —
    sample-sort regular sampling.  On a multi-process mesh every process
    sees only its addressable shards, so the local sample blocks are
    exchanged with one deterministic process all-gather; every process
    computes identical splitters.

    Returns a replicated device array ([D-1] uint32, NamedSharding P()).
    """
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    S = samples
    counts_by_pos = {
        (s.index[0].start or 0) // block: np.asarray(s.data)
        for s in counts.addressable_shards
    }
    lane0_by_pos = {
        (s.index[1].start or 0) // block: np.asarray(s.data)[0]
        for s in lanes.addressable_shards
    }
    i = np.arange(S, dtype=np.int64)
    local = np.empty((len(counts_by_pos), S), np.uint32)
    for row, pos in enumerate(sorted(counts_by_pos)):
        c = counts_by_pos[pos]
        U = int((c > 0).sum())
        if U == 0:
            local[row] = np.uint32(0xFFFFFFFF)
        else:
            idx = ((2 * i + 1) * U) // (2 * S)
            local[row] = lane0_by_pos[pos][np.minimum(idx, U - 1)]
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        pooled = np.asarray(
            multihost_utils.process_allgather(local)
        ).reshape(-1)
    else:
        pooled = local.reshape(-1)
    assert pooled.size == num_devices * S, (pooled.size, num_devices, S)
    pooled = np.sort(pooled)
    splitters = pooled[np.arange(1, num_devices) * S]
    return jax.device_put(
        jnp.asarray(splitters), NamedSharding(mesh, PartitionSpec())
    )


def owner_of_splitters(
    lane0: jnp.ndarray, splitters: jnp.ndarray
) -> jnp.ndarray:
    """Monotonic owner assignment against sampled range boundaries:
    owner(key) = #{d : key >= splitters[d]} — a sum of step functions,
    hence monotonic in the key, preserving the sorted-concat property."""
    return jnp.sum(
        (lane0[:, None] >= splitters[None, :]).astype(jnp.int32), axis=1
    )


def route_merge_local(
    lanes: jnp.ndarray,
    counts: jnp.ndarray,
    axis_name: str,
    num_devices: int,
    bucket_capacity: int,
    splitters: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exchange records so each device holds exactly its key range, merged.

    Args (per-device views inside shard_map; record arrays lane-major):
      lanes: [NL, C] uint32 local partial table; slots with count 0 ignored.
        Live rows must be dense at the front and sorted ascending (the
        sort_reduce contract) — the splitter sampler
        depends on it.
      counts: [C] uint32.
      axis_name: mesh axis to exchange over.
      num_devices: size of that axis (static).
      bucket_capacity: per-destination slot budget (static).  Worst case is
        C (everything owned by one device); callers trade memory for skew
        tolerance — overflow is *detected*, never silent.
      splitters: optional [D-1] uint32 range boundaries (replicated; from
        sample_splitters) — skew-adaptive routing.  None = the uniform
        lead-lane split.  Callers that route more than once (spill epochs
        + final merge) MUST pass the SAME splitters every time: the
        per-position ranges written across epochs are only disjoint and
        concatenation-sorted if the partition never moves.

    Returns:
      (range_lanes [NL, D*cap], range_counts [D*cap], num_unique, overflow)
      where overflow > 0 means bucket_capacity was exceeded somewhere
      (global max) and the merge must be retried with more slack.
    """
    NL, C = lanes.shape
    D = num_devices
    cap = bucket_capacity

    valid = counts > 0
    if splitters is not None and D > 1:
        base_owner = owner_of_splitters(lanes[0], splitters)
    else:
        base_owner = owner_of(lanes[0], D)
    owner = jnp.where(valid, base_owner, D)  # D = dropped

    # Group records by destination. Rather than scattering into [D, cap]
    # buckets, sort by a composite placement key
    # ``owner * cap + slot``: after sorting, record with placement key p
    # sits at position... not directly — instead sort by owner (grouping),
    # then *place* each record at owner*cap + rank-within-owner via one
    # more sort keyed by that placement index over a padded [D*cap] domain.
    ops = (owner, *(lanes[i] for i in range(NL)), counts)
    sorted_ops = jax.lax.sort(ops, dimension=0, num_keys=1, is_stable=True)
    s_owner = sorted_ops[0]
    s_lanes = jnp.stack(sorted_ops[1 : NL + 1], axis=0)
    s_counts = sorted_ops[NL + 1]

    # Rank within owner run + overflow detection.
    idx = jnp.arange(C, dtype=jnp.int32)
    run_start = jnp.searchsorted(s_owner, jnp.arange(D + 1, dtype=jnp.int32))
    slot = idx - run_start[jnp.clip(s_owner, 0, D)]
    per_dest = run_start[1:] - run_start[:-1]
    overflow_local = jnp.maximum(jnp.max(per_dest) - cap, 0)

    # Placement by sort (scatter-free): each record's target position in
    # the [D*cap] send buffer is owner*cap + slot; records beyond cap or
    # ownerless get position >= D*cap.  Pad the domain to D*cap + C
    # carrying empty filler, sort by position, take the first D*cap.
    pos = jnp.where(
        (s_owner < D) & (slot < cap),
        s_owner * cap + slot,
        D * cap + idx,
    )
    filler_pos = jnp.arange(D * cap, dtype=jnp.int32)
    # filler occupies every position with the lowest priority: sort is
    # stable, real records share no positions with each other, and each
    # position's real record (if any) precedes... stability does not order
    # record-vs-filler at equal keys deterministically by construction, so
    # disambiguate by a secondary key: real=0, filler=1.
    all_pos = jnp.concatenate([pos, filler_pos])
    is_filler = jnp.concatenate(
        [jnp.zeros((C,), jnp.int32), jnp.ones((D * cap,), jnp.int32)]
    )
    all_lanes = jnp.concatenate(
        [s_lanes, jnp.zeros((NL, D * cap), jnp.uint32)], axis=1
    )
    all_counts = jnp.concatenate([s_counts, jnp.zeros((D * cap,), jnp.uint32)])
    placed = jax.lax.sort(
        (all_pos, is_filler, *(all_lanes[i] for i in range(NL)), all_counts),
        dimension=0,
        num_keys=2,
    )
    # After sorting by (pos, is_filler): for each position p < D*cap, the
    # real record (if any) comes first, its filler right after; positions
    # without a real record contribute just the filler.  Keep exactly the
    # entries whose (pos, rank-within-pos) make them the position owners:
    # the first occurrence of each pos value.  Since each pos in [0, D*cap)
    # occurs once (filler) or twice (record+filler), "first occurrence"
    # compaction is another sort over a boundary key — but cheaper: the
    # occupied flag is placed[1]==0, and duplicates are adjacent, so a
    # shift-compare suffices.
    p_pos = placed[0]
    first = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), p_pos[1:] != p_pos[:-1]]
    )
    # Compact the firsts to the front: they are exactly D*cap entries, and
    # their pos values are 0..D*cap-1 in order, so sorting by
    # (first ? pos : BIG) yields them densely in the first D*cap slots.
    comp_key = jnp.where(first, p_pos, jnp.int32(2 * D * cap + C))
    compd = jax.lax.sort(
        (comp_key, *(placed[2 + i] for i in range(NL)), placed[2 + NL]),
        dimension=0,
        num_keys=1,
    )
    send_lanes = jnp.stack(
        [compd[1 + i][: D * cap].reshape(D, cap) for i in range(NL)], axis=0
    )
    send_counts = compd[1 + NL][: D * cap].reshape(D, cap)

    # One collective: bucket d goes to device d; we receive D buckets.
    recv_lanes = jax.lax.all_to_all(
        send_lanes, axis_name, split_axis=1, concat_axis=1, tiled=False
    )
    recv_counts = jax.lax.all_to_all(
        send_counts, axis_name, split_axis=0, concat_axis=0, tiled=False
    )

    # Collapse the received runs: one sort-reduce over D*cap records.
    flat_lanes = recv_lanes.reshape(NL, D * cap)
    flat_counts = recv_counts.reshape(D * cap)
    out_lanes, out_counts, num_unique = sort_reduce(flat_lanes, flat_counts)

    overflow = jax.lax.pmax(overflow_local, axis_name)
    return out_lanes, out_counts, num_unique, overflow
