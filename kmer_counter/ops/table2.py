"""Two-level HBM count table: deduped sorted prefix + keys-only raw region.

The single-buffer table (ops.table) re-sorts *everything* — previously
consolidated records included — through a 3-operand dedup sort plus a
4-operand compaction sort on every consolidation.  This variant is the
same scatter-free design (SURVEY §2.1: the reference's dormant
sortKmers+reduceKMers epoch, GPUHandler.cu:300-360) restructured so that

  * raw k-mer records carry **no count operand at all**: a raw record is
    valid iff its key lanes are not the all-ones sentinel (ops.pipeline
    writes sentinels for masked windows), so the raw dedup sort moves NL
    key lanes and nothing else;
  * per-key raw counts are pure **index arithmetic** on the sorted raw
    region (run length = next boundary position − mine);
  * the previously consolidated prefix never passes through the raw
    dedup sort again: one 3-operand merge sort (NL key lanes + counts)
    over [collapsed prefix ++ raw boundary rows] both merges and
    compacts — sentinel rows sort to the end and are truncated.

Per consolidation that is ``NL·CR + (NL+1)·(CP+CR)`` operand-slots versus
the single-buffer table's ``(2NL+1)·C + (NL+2)·C``, and consolidated
records are re-sorted through 1 sort instead of 2.

Prefix invariant: rows [0, CP) sorted ascending by key with **at most two
live rows per key** (one carried count from earlier rounds + one from the
latest merge); count-0 rows only at the tail.  ``_collapse_prefix`` folds
duplicate-key runs of any length onto their first row before each merge,
restoring uniqueness, and ``finalize`` (a plain sort_reduce) produces the
fully deduped compacted table for dumping.

All-T^k special case: when k % 16 == 0 a forward-strand all-T k-mer is
bit-identical to the sentinel, so the extractor counts those windows into
a side scalar (``allt``) instead of the key stream; the host dump layer
re-materializes the single T^k record (it is the maximum possible key, so
it always belongs at the very end of the sorted output).  Canonical mode
never produces it (canonical(T^k) = A^k).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kmer_counter.ops.sortcount import device_sort, sort_reduce

SENTINEL = jnp.uint32(0xFFFFFFFF)


class TwoLevelTable(NamedTuple):
    """Device state for the two-level count table."""

    prefix_lanes: jnp.ndarray  # [NL, CP] uint32, sorted, ≤2 live rows/key
    prefix_counts: jnp.ndarray  # [CP] uint32 (0 = empty slot)
    raw_lanes: jnp.ndarray  # [NL, CR] uint32 keys-only (sentinel = invalid)
    raw_off: jnp.ndarray  # scalar int32: raw slots in use
    allt: jnp.ndarray  # scalar uint32: side count of all-T k-mers (k%16==0)


def make_table2(prefix_slots: int, raw_slots: int, num_lanes: int) -> TwoLevelTable:
    return TwoLevelTable(
        prefix_lanes=jnp.zeros((num_lanes, prefix_slots), dtype=jnp.uint32),
        prefix_counts=jnp.zeros((prefix_slots,), dtype=jnp.uint32),
        raw_lanes=jnp.zeros((num_lanes, raw_slots), dtype=jnp.uint32),
        raw_off=jnp.int32(0),
        allt=jnp.uint32(0),
    )


@partial(jax.jit, donate_argnums=(0,))
def append_raw(table: TwoLevelTable, chunk_lanes, chunk_allt) -> TwoLevelTable:
    """Append one chunk's sentinel-encoded key lanes at the raw offset.

    The caller guarantees raw_off + chunk ≤ CR (the host mirrors raw_off
    exactly: appends advance by the chunk's static width).
    """
    raw = jax.lax.dynamic_update_slice(
        table.raw_lanes, chunk_lanes, (jnp.int32(0), table.raw_off)
    )
    return table._replace(
        raw_lanes=raw,
        raw_off=table.raw_off + jnp.int32(chunk_lanes.shape[1]),
        allt=table.allt + chunk_allt,
    )


def _next_boundary_pos(boundary: jnp.ndarray) -> jnp.ndarray:
    """For each row, the position of the nearest boundary strictly after
    it (N when none).  int32 position math — immune to count wraparound."""
    n = boundary.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    bpos = jnp.where(boundary, idx, n)
    nearest_at_or_after = jax.lax.cummin(bpos, reverse=True)
    return jnp.concatenate(
        [nearest_at_or_after[1:], jnp.full((1,), n, dtype=jnp.int32)]
    )


def _fill_from_right(flags: jnp.ndarray, vals: jnp.ndarray, fill):
    """out[i] = vals[j] for the smallest j >= i with flags[j]; ``fill``
    where no such j exists.  A suffix select-scan — the gather-free way to
    read "the value at the next marked row".  The combine (leftmost flagged
    wins) is associative, and it is wraparound-safe: values are selected,
    never added."""

    def comb(a, b):
        # reverse=True flips, scans forward, flips back: the element nearer
        # the ORIGINAL left arrives as ``b``, and it wins when flagged.
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va)

    # Unflagged slots carry ``fill``: when nothing is flagged at or after i,
    # the select chain bottoms out at the last slot's fill value.
    _, out = jax.lax.associative_scan(
        comb, (flags, jnp.where(flags, vals, fill)), reverse=True
    )
    return out


def _collapse_prefix(lanes: jnp.ndarray, counts: jnp.ndarray):
    """Fold duplicate-key runs onto their first row (sorted input, holes
    allowed).  Returns (eff_lanes, collapsed_counts) where non-first rows
    and holes are sentinel-keyed with count 0.  Uses the u32 exclusive-
    cumsum difference (wraparound cancels, see ops.sortcount)."""
    NL, CP = lanes.shape
    valid = counts > 0
    eff = jnp.where(valid[None, :], lanes, SENTINEL)
    is_sent = jnp.all(eff == SENTINEL, axis=0)
    prev_differs = jnp.any(eff[:, 1:] != eff[:, :-1], axis=0)
    boundary = jnp.concatenate([jnp.ones((1,), dtype=bool), prev_differs])
    csum = jnp.cumsum(counts)
    starts = csum - counts
    # starts at the next boundary == inclusive csum at the end of my run:
    # a gather-free suffix fill from run-end rows.
    is_end = jnp.concatenate([boundary[1:], jnp.ones((1,), dtype=bool)])
    start_next = _fill_from_right(is_end, csum, csum[-1])
    run_total = start_next - starts  # u32 wrap cancels
    keep = boundary & ~is_sent
    new_counts = jnp.where(keep, run_total, jnp.uint32(0))
    new_lanes = jnp.where(keep[None, :], eff, SENTINEL)
    return new_lanes, new_counts


def _reduce_raw(raw_lanes: jnp.ndarray, raw_off) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Keys-only dedup of the raw region: sort NL lanes, then per-key
    counts as boundary-position differences (every live raw record has
    implicit count 1).  Rows at/past raw_off are masked to sentinel."""
    NL, CR = raw_lanes.shape
    idx = jnp.arange(CR, dtype=jnp.int32)
    live = idx < raw_off
    eff = jnp.where(live[None, :], raw_lanes, SENTINEL)
    sorted_ops = device_sort(tuple(eff[i] for i in range(NL)), num_keys=NL)
    s = jnp.stack(sorted_ops, axis=0)
    is_sent = jnp.all(s == SENTINEL, axis=0)
    prev_differs = jnp.any(s[:, 1:] != s[:, :-1], axis=0)
    boundary = jnp.concatenate([jnp.ones((1,), dtype=bool), prev_differs])
    nb = _next_boundary_pos(boundary)
    keep = boundary & ~is_sent
    counts = jnp.where(keep, (nb - idx).astype(jnp.uint32), jnp.uint32(0))
    lanes = jnp.where(keep[None, :], s, SENTINEL)
    return lanes, counts


@partial(jax.jit, donate_argnums=(0,))
def consolidate2(table: TwoLevelTable):
    """Merge the raw region into the prefix.

    Returns (table', live, lost): live = prefix rows in use afterwards;
    lost = live records truncated (must be 0 — the host sizes/grows the
    prefix so the merge always fits; nonzero is a hard error).
    """
    NL, CP = table.prefix_lanes.shape
    p_lanes, p_counts = _collapse_prefix(table.prefix_lanes, table.prefix_counts)
    r_lanes, r_counts = _reduce_raw(table.raw_lanes, table.raw_off)
    lanes_cat = jnp.concatenate([p_lanes, r_lanes], axis=1)
    counts_cat = jnp.concatenate([p_counts, r_counts])
    merged = device_sort(
        (*(lanes_cat[i] for i in range(NL)), counts_cat), num_keys=NL
    )
    m_lanes = jnp.stack(merged[:NL], axis=0)
    m_counts = merged[NL]
    live = jnp.sum((m_counts[:CP] > 0).astype(jnp.int32))
    lost = jnp.sum((m_counts[CP:] > 0).astype(jnp.int32))
    out = table._replace(
        prefix_lanes=m_lanes[:, :CP],
        prefix_counts=m_counts[:CP],
        raw_off=jnp.int32(0),
    )
    return out, live, lost


@partial(jax.jit, static_argnames=("prefix_slots", "raw_slots"))
def grow2(table: TwoLevelTable, prefix_slots: int, raw_slots: int) -> TwoLevelTable:
    """Copy into larger buffers (host-triggered under cardinality growth)."""
    NL, CP = table.prefix_lanes.shape
    CR = table.raw_lanes.shape[1]
    if prefix_slots < CP or raw_slots < CR:
        raise ValueError("grow2() cannot shrink the table")
    pl = jnp.zeros((NL, prefix_slots), jnp.uint32).at[:, :CP].set(table.prefix_lanes)
    pc = jnp.zeros((prefix_slots,), jnp.uint32).at[:CP].set(table.prefix_counts)
    rl = jnp.zeros((NL, raw_slots), jnp.uint32).at[:, :CR].set(table.raw_lanes)
    return TwoLevelTable(pl, pc, rl, table.raw_off, table.allt)


@jax.jit
def finalize2(table: TwoLevelTable):
    """Fully deduped compacted prefix (raw region must already be merged:
    raw_off == 0).  Returns (lanes [NL, CP], counts, num_unique) per the
    sort_reduce contract; the allt side count is handled by the caller
    (use ``finalize_host`` for the complete, checked protocol)."""
    return sort_reduce(table.prefix_lanes, table.prefix_counts)


def raw_append_fits(table: TwoLevelTable, chunk_width: int) -> bool:
    """Host-side overflow guard for ``append_raw``: the host mirrors
    raw_off exactly (appends advance by the chunk's static width), so this
    check is authoritative.  A violated bound would make
    ``dynamic_update_slice`` silently clamp and overwrite the newest
    previously-appended records — callers must consolidate
    (or grow) when this returns False."""
    return int(jax.device_get(table.raw_off)) + chunk_width <= table.raw_lanes.shape[1]


def finalize_host(table: TwoLevelTable, k: int):
    """The one checked host-side finalize for a TwoLevelTable.

    Centralizes the two protocol obligations that would otherwise be on
    every caller: (a) any outstanding raw region is merged and
    a nonzero ``lost`` (live records truncated by an undersized prefix) is
    a hard error, never silent truncation; (b) when k % 16 == 0 in forward
    mode, the all-T k-mer — bit-identical to the sentinel, so counted out
    of band (see module docstring) — is re-materialized as the final,
    maximum-key record.

    Returns (lanes ``[num_unique, NL] uint32`` record-major, counts
    ``[num_unique] uint32``), keys sorted ascending — ready for
    io.dump.dump_table.
    """
    import numpy as np

    if int(jax.device_get(table.raw_off)) > 0:
        table, _live, lost = consolidate2(table)
        lost = int(jax.device_get(lost))
        if lost:
            raise RuntimeError(
                f"two-level consolidation truncated {lost} live records: "
                "prefix region undersized (grow2 before finalize)"
            )
    lanes, counts, num_unique = finalize2(table)
    n = int(jax.device_get(num_unique))
    NL = table.prefix_lanes.shape[0]
    out_lanes = (
        np.asarray(jax.device_get(lanes[:, :n])).T
        if n
        else np.zeros((0, NL), np.uint32)
    )
    out_counts = np.asarray(jax.device_get(counts[:n]), dtype=np.uint32)
    allt = int(jax.device_get(table.allt))
    if allt:
        # T^k packs to all-ones in every active lane: the maximum possible
        # key, so appending keeps the table sorted.
        tk = np.full((1, NL), 0xFFFFFFFF, np.uint32)
        if out_lanes.shape[0] and np.array_equal(out_lanes[-1], tk[0]):
            # A real error type (not assert): this must fire under python -O
            # too — it means extract_chunk_keys leaked a sentinel-valued key
            # into the stream and counts would silently double.
            raise RuntimeError(
                "all-T key present in the key stream despite the side "
                "counter: extract_chunk_keys contract violated"
            )
        out_lanes = np.concatenate([out_lanes, tk], axis=0)
        out_counts = np.concatenate(
            [out_counts, np.asarray([allt], np.uint32)]
        )
    return out_lanes, out_counts
