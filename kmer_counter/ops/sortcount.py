"""Sort + segment-reduce counting — the design the reference left dormant.

The reference's active path copies every extracted k-mer back to the host
and inserts it into a TBB concurrent hash map (KMerCounter.cpp:51-89); its
*intended* design — a Thrust device sort followed by an adjacent-duplicate
reduce — exists but is commented out (GPUHandler.cu:300-327 sortKmers,
:340-360 reduceKMers, call site :456-458).  This module is that design in
XLA: ``jax.lax.sort`` does a multi-operand lexicographic sort over the
uint32 key lanes, and the duplicate-collapse becomes vectorized
boundary/cumsum arithmetic with fully static shapes.

The implementation is **scatter-free**, using three tricks:

  1. Empty slots (count 0) have their key lanes replaced by the all-ones
     sentinel, so they sort to the end and coalesce into (at most) one
     trailing group whose count sums to 0; a final adjustment drops that
     group from ``num_unique``.  No separate validity sort key is needed.
  2. Per-segment totals come from an (exclusive) cumulative sum of the
     sorted counts: the value at each segment's first row is the segment's
     start offset, and consecutive compacted start offsets difference into
     exact segment totals (uint32 wraparound cancels in the subtraction).
  3. Compaction (dense unique rows) is one more ``lax.sort`` keyed by
     ``segment_id if boundary else N``.

Empty/invalid slots carry count==0 throughout, so one primitive handles
both raw window streams (counts ∈ {0,1}) and accumulated partial tables
(arbitrary counts) — table consolidation (ops.table) is the same op.

All record arrays are **lane-major** ``[NL, N]`` (lane i of record n at
``[i, n]``): each lane is one contiguous sort operand.

Contract: slots [0, num_unique) hold distinct keys sorted ascending with
their summed counts; slots at and past num_unique have count 0 and
*unspecified* key lanes (every consumer must gate on count > 0).

Known limitation (inherited from the reference's uint32 count field,
KMerSizes.h:10-28): a single k-mer observed more than 2^32-1 times wraps
on device; the host merge paths (io.spill, native kc_merge_runs) saturate
at the uint32 maximum instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def device_sort(operands, num_keys: int):
    """Unstable lexicographic ``jax.lax.sort`` over the first ``num_keys``
    operands.  Every caller collapses equal keys by run totals, so the
    order within a tie is unobservable and stability would buy nothing."""
    return jax.lax.sort(
        tuple(operands), dimension=0, num_keys=num_keys, is_stable=False
    )


def sort_reduce(
    lanes: jnp.ndarray, counts: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Collapse duplicate keys by sorting and summing counts.

    Args:
      lanes: ``[NL, N] uint32`` lane-major key lanes; records with count 0
        are ignored (their lane content is irrelevant).
      counts: ``[N] uint32`` per-record counts (0 = empty slot).

    Returns:
      (unique_lanes ``[NL, N]``, unique_counts ``[N]``, num_unique scalar):
      distinct keys sorted ascending in slots [0, num_unique); slots past
      that have count 0 and unspecified lanes.
    """
    NL, N = lanes.shape
    counts = counts.astype(jnp.uint32)
    valid = counts > 0

    # (1) sentinel: empty rows become all-ones keys -> sort to the end.
    sentinel = jnp.uint32(0xFFFFFFFF)
    eff = jnp.where(valid[None, :], lanes, sentinel)

    operands = (*(eff[i] for i in range(NL)), counts)
    sorted_ops = device_sort(operands, num_keys=NL)
    s_lanes = jnp.stack(sorted_ops[:NL], axis=0)
    s_counts = sorted_ops[NL]

    # Segment boundaries: first slot of each run of equal keys.
    prev_differs = jnp.any(s_lanes[:, 1:] != s_lanes[:, :-1], axis=0)
    boundary = jnp.concatenate([jnp.ones((1,), dtype=bool), prev_differs])
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    U = seg[-1] + 1  # segments incl. a possible trailing sentinel group

    # (2) exclusive cumsum: value at a segment's first slot == segment start.
    csum = jnp.cumsum(s_counts)
    total = csum[-1]
    starts = csum - s_counts

    # (3) compaction by sort: boundary slots get their (unique, ascending)
    # segment id as key, everything else key N.
    comp_key = jnp.where(boundary, seg, N).astype(jnp.uint32)  # values <= N < 2^31
    comp_ops = (comp_key, *(s_lanes[i] for i in range(NL)), starts)
    comp = device_sort(comp_ops, num_keys=1)
    u_lanes = jnp.stack(comp[1 : NL + 1], axis=0)
    u_starts = comp[NL + 1]

    idx = jnp.arange(N, dtype=jnp.int32)
    in_range = idx < U
    s_fixed = jnp.where(in_range, u_starts, total)
    s_next = jnp.concatenate([s_fixed[1:], total[None]])
    u_counts = jnp.where(in_range, s_next - s_fixed, jnp.uint32(0))

    # Drop the trailing all-sentinel group (its count summed to 0).  A
    # genuine all-T key group that absorbed sentinels keeps count > 0 and
    # is (correctly) retained.
    last_count = jnp.take(u_counts, jnp.maximum(U - 1, 0))
    num_unique = jnp.maximum(U - jnp.where(last_count == 0, 1, 0), 0)
    num_unique = num_unique.astype(jnp.int32)
    return u_lanes, u_counts, num_unique
