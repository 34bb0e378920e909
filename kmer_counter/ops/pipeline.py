"""Fused per-chunk counting step: encode → extract → sort-count.

One jitted function replaces the reference's per-chunk GPU driver
processKMers (GPUHandler.cu:397-477): where the reference launches two
kernels with a stream-sync after each, copies all k-mers to the host and
reduces there, this traces the whole chunk into a single XLA program that
never leaves the device and returns a compacted partial count table.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from kmer_counter.ops.encode import encode_reads
from kmer_counter.ops.extract import (
    extract_kmer_lanes,
    extract_kmer_lanes_t,
)
from kmer_counter.ops.sortcount import sort_reduce


def _extract_flat(reads, k: int, canonical: bool):
    """(lanes [NL, N], wvalid [N]) for one chunk, N = R*(L-k+1).

    Narrow records (NL <= 2, k <= 32) extract TRANSPOSED
    (extract.extract_kmer_lanes_t): the read axis is the minor dim and
    the output flatten is contiguous.  The window order becomes
    position-major, which no consumer observes (the raw region is
    sorted).  Wide records stay read-major.  Both orientations give the
    same records; which one is faster on the GPU at each k is not
    measured yet.
    """
    from kmer_counter.records import active_lanes

    if active_lanes(k) <= 2:
        codes, valid = encode_reads(reads.T)
        lanes, wvalid = extract_kmer_lanes_t(codes, valid, k, canonical)
        NL, P, R = lanes.shape
        return lanes.reshape(NL, P * R), wvalid.reshape(P * R)
    codes, valid = encode_reads(reads)
    lanes, wvalid = extract_kmer_lanes(codes, valid, k, canonical)
    NL, R, P = lanes.shape
    return lanes.reshape(NL, R * P), wvalid.reshape(R * P)


@partial(jax.jit, static_argnames=("k", "canonical"))
def extract_chunk(
    reads: jnp.ndarray, k: int, canonical: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Extract one chunk's raw k-mer records — no sorting.

    Returns lane-major (lanes ``[NL, R*(L-k+1)] uint32``, counts
    ``[R*(L-k+1)] uint32`` with count 1 for valid windows, 0 for masked
    ones).  This is the hot per-chunk op in the steady-state engine loop:
    records append to the HBM table unsorted and *all* duplicate-collapse
    work happens in the amortized consolidation sort
    (ops.table.consolidate), which profiling shows is strictly cheaper
    than sorting every chunk.
    """
    flat, wv = _extract_flat(reads, k, canonical)
    return flat, wv.astype(jnp.uint32)


@partial(jax.jit, static_argnames=("k", "canonical"))
def extract_chunk_keys(
    reads: jnp.ndarray, k: int, canonical: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Extract one chunk's k-mer keys with validity encoded in-band.

    Like extract_chunk but returns no counts operand at all: masked
    windows get the all-ones sentinel key, so a raw record is valid iff
    its lanes differ from the sentinel (ops.table2's keys-only raw
    region).  Returns (lanes ``[NL, R*(L-k+1)] uint32``, allt scalar
    uint32): when k % 16 == 0 and not canonical, a valid all-T k-mer is
    bit-identical to the sentinel, so those windows are tallied into
    ``allt`` instead of the key stream (canonical(T^k) = A^k, so the
    canonical path never produces the sentinel pattern).
    """
    flat, wv = _extract_flat(reads, k, canonical)
    sentinel = jnp.uint32(0xFFFFFFFF)
    if k % 16 == 0 and not canonical:
        is_allt = jnp.all(flat == sentinel, axis=0) & wv
        allt = jnp.sum(is_allt.astype(jnp.uint32))
        wv = wv & ~is_allt
    else:
        allt = jnp.uint32(0)
    return jnp.where(wv[None, :], flat, sentinel), allt


@partial(jax.jit, donate_argnums=(0,), static_argnames=("k", "canonical"))
def count_step_two_level(table, reads: jnp.ndarray, k: int, canonical: bool = False):
    """Fused chunk step for the two-level table: extract keys + raw append
    as ONE compiled program.

    The append offset is the table's own device-resident ``raw_off`` (no
    host scalar upload, no static-offset executable variants): the
    two-level steady state compiles exactly one program per (k, canonical,
    shapes).

    The caller must guarantee raw_off + chunk ≤ CR (host-mirrored bound,
    see ops.table2.raw_append_fits); the reference's analog of this step
    is processKMers' encode+extract launch pair (GPUHandler.cu:397-448).
    """
    lanes, allt = extract_chunk_keys(reads, k, canonical)
    raw = jax.lax.dynamic_update_slice(
        table.raw_lanes, lanes, (jnp.int32(0), table.raw_off)
    )
    return table._replace(
        raw_lanes=raw,
        raw_off=table.raw_off + jnp.int32(lanes.shape[1]),
        allt=table.allt + allt,
    )


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_chunk(
    reads: jnp.ndarray, k: int, canonical: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Count k-mers of one dense read chunk.

    Args:
      reads: ``[R, L] uint8`` ASCII base matrix (rows shorter than L must be
        padded with a non-ACGT byte, e.g. 0, which masks them out).
      k: k-mer length.
      canonical: canonical (min(kmer, revcomp)) keys if True.

    Returns:
      (unique_lanes ``[NL, R*(L-k+1)] uint32``, counts, num_unique) —
      the chunk's compacted partial table, keys sorted ascending,
      lane-major.
    """
    flat_lanes, flat_counts = extract_chunk(reads, k, canonical)
    return sort_reduce(flat_lanes, flat_counts)


def chunk_slots(n_reads: int, line_length: int, k: int) -> int:
    """Worst-case k-mer slots for a chunk — the analog of the reference's
    calculateOutputSize (GPUHandler.cu:235-245)."""
    return n_reads * max(line_length - k + 1, 0)
