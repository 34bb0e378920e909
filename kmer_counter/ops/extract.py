"""Windowed k-mer extraction — the device twin of the reference's extractKMers.

The reference kernel (GPUHandler.cu:129-233) walks each read serially,
tracking a run-length of valid bases and assembling each k-mer with
data-dependent funnel shifts over the packed words.  The design here is
whole-chunk and data-independent instead, so XLA can fuse it:

  * Every window position of every read is computed unconditionally —
    static shapes, perfect vectorization; invalid windows are masked.
  * A **log-tree pack** builds, in 4 full-width shift-or passes, the value
    ``A[p]`` = the 16 bases starting at p, MSB-first in 32 bits — for
    *every* offset p simultaneously.  Each key lane of each window is then
    a slice of A (plus a tail mask for partial lanes).
  * Reverse-complement lanes come from the *same* tree: complement is
    bitwise NOT of the 2-bit codes, and base-order reversal within a
    32-bit group is a fixed 4-step bit permutation (``_rev_groups``), so
    canonicalization needs no second pass over the reads and no flips.
  * Window validity is a log-doubling sliding OR over the invalid mask —
    the vector form of the reference's valid-run counter
    (GPUHandler.cu:155-172).

Everything is lane-major ``[NL, R, P]`` (see ops.sortcount for why).
"""

from __future__ import annotations

import jax.numpy as jnp

from kmer_counter.records import BASES_PER_LANE, active_lanes


def _pack_tree(codes: jnp.ndarray) -> jnp.ndarray:
    """codes ``[R, L] uint32`` → ``A [R, L]`` with A[:, p] packing bases
    p..p+15 MSB-first in 32 bits (zero-padded past the read end).

    A_{m+1}[p] = A_m[p] << 2*2^m | A_m[p + 2^m]; four doubling levels.
    """
    A = jnp.pad(codes, ((0, 0), (0, BASES_PER_LANE - 1)))
    for m in range(4):
        sh = 1 << m
        A = (A[:, : A.shape[1] - sh] << jnp.uint32(2 * sh)) | A[:, sh:]
    return A


def _rev_groups(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups of each uint32 (base-order flip)."""
    m1 = jnp.uint32(0x33333333)
    m2 = jnp.uint32(0x0F0F0F0F)
    m3 = jnp.uint32(0x00FF00FF)
    v = ((v & m1) << 2) | ((v >> 2) & m1)
    v = ((v & m2) << 4) | ((v >> 4) & m2)
    v = ((v & m3) << 8) | ((v >> 8) & m3)
    return (v << 16) | (v >> 16)


def _fwd_lanes(A: jnp.ndarray, k: int, P: int) -> list[jnp.ndarray]:
    """Forward key lanes from the pack tree: lane i of window p is
    A[p + 16i], tail-masked for the partial last lane.

    Only the ceil(k/16) *active* lanes are produced (records.active_lanes)
    — the ABI's zero pad lanes would just widen every sort downstream.
    """
    lanes = []
    for i in range(active_lanes(k)):
        base0 = i * BASES_PER_LANE
        n_bases = min(BASES_PER_LANE, k - base0)
        v = A[:, base0 : base0 + P]
        if n_bases < BASES_PER_LANE:
            drop = jnp.uint32(2 * (BASES_PER_LANE - n_bases))
            v = (v >> drop) << drop
        lanes.append(v)
    return lanes


def _rc_lanes(A: jnp.ndarray, k: int, P: int) -> list[jnp.ndarray]:
    """Reverse-complement key lanes from the same tree.

    rc lane i covers window bases [k-16(i+1), k-16i) reversed-complemented:
    complement = bitwise NOT; reversal = _rev_groups; the partial last lane
    reverses the window's first n bases and left-aligns them.
    """
    lanes = []
    for i in range(active_lanes(k)):
        n_bases = min(BASES_PER_LANE, k - i * BASES_PER_LANE)
        if n_bases == BASES_PER_LANE:
            off = k - BASES_PER_LANE * (i + 1)
            lanes.append(_rev_groups(~A[:, off : off + P]))
        else:
            v = _rev_groups(~A[:, 0:P])
            lanes.append(v << jnp.uint32(2 * (BASES_PER_LANE - n_bases)))
    return lanes


def _lex_min(a: list[jnp.ndarray], b: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Elementwise lexicographic min of two lane lists."""
    NL = len(a)
    a_lt = jnp.zeros(a[0].shape, dtype=bool)
    for i in reversed(range(NL)):
        a_lt = jnp.where(a[i] == b[i], a_lt, a[i] < b[i])
    return [jnp.where(a_lt, a[i], b[i]) for i in range(NL)]


def _window_valid(valid: jnp.ndarray, k: int) -> jnp.ndarray:
    """valid ``[R, L] bool`` → window validity ``[R, P] bool`` via a
    log-doubling sliding OR over the invalid mask."""
    inv = ~valid
    covered = 1
    cur = inv
    while covered < k:
        step = min(covered, k - covered)
        cur = cur[:, : cur.shape[1] - step] | cur[:, step:]
        covered += step
    P = valid.shape[1] - k + 1
    return ~cur[:, :P]


def extract_kmer_lanes(
    codes: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    canonical: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Extract all k-mer windows of a chunk.

    Args:
      codes: ``[R, L] uint32`` 2-bit base codes (from ops.encode).
      valid: ``[R, L] bool`` per-base validity.
      k: k-mer length (1..128).
      canonical: if True keys are min(kmer, revcomp(kmer)).

    Returns:
      (lanes ``[NLa, R, P] uint32`` with NLa = records.active_lanes(k),
      window_valid ``[R, P] bool``) with
      P = L - k + 1.  k-mers never cross reads (one window set per row),
      matching the reference's per-read sections (GPUHandler.cu:438-439).
    """
    R, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"line length {L} shorter than k={k}")
    A = _pack_tree(codes)
    lanes = _fwd_lanes(A, k, P)
    if canonical:
        lanes = _lex_min(_rc_lanes(A, k, P), lanes)
    wvalid = _window_valid(valid, k)
    return jnp.stack(lanes, axis=0), wvalid


# ---------------------------------------------------------------------------
# Transposed orientation: [L, R] codes, [NL, P, R] lanes.
#
# In the [R, P] orientation the window axis P = L-k+1 is the minor
# dimension.  Transposed, the read axis R is minor and the output reshape
# [NL, P, R] → [NL, P*R] is contiguous.  Window order becomes
# position-major instead of read-major — irrelevant, every consumer sorts
# the raw region.


def _pack_tree_t(codes_t: jnp.ndarray) -> jnp.ndarray:
    """codes ``[L, R] uint32`` → ``A [L+15, R]`` with A[p] packing bases
    p..p+15 MSB-first in 32 bits (zero-padded past the read end)."""
    A = jnp.pad(codes_t, ((0, BASES_PER_LANE - 1), (0, 0)))
    for m in range(4):
        sh = 1 << m
        A = (A[: A.shape[0] - sh] << jnp.uint32(2 * sh)) | A[sh:]
    return A


def _fwd_lanes_t(A: jnp.ndarray, k: int, P: int) -> list[jnp.ndarray]:
    lanes = []
    for i in range(active_lanes(k)):
        base0 = i * BASES_PER_LANE
        n_bases = min(BASES_PER_LANE, k - base0)
        v = A[base0 : base0 + P]
        if n_bases < BASES_PER_LANE:
            drop = jnp.uint32(2 * (BASES_PER_LANE - n_bases))
            v = (v >> drop) << drop
        lanes.append(v)
    return lanes


def _rc_lanes_t(A: jnp.ndarray, k: int, P: int) -> list[jnp.ndarray]:
    lanes = []
    for i in range(active_lanes(k)):
        n_bases = min(BASES_PER_LANE, k - i * BASES_PER_LANE)
        if n_bases == BASES_PER_LANE:
            off = k - BASES_PER_LANE * (i + 1)
            lanes.append(_rev_groups(~A[off : off + P]))
        else:
            v = _rev_groups(~A[0:P])
            lanes.append(v << jnp.uint32(2 * (BASES_PER_LANE - n_bases)))
    return lanes


def _window_valid_t(valid_t: jnp.ndarray, k: int) -> jnp.ndarray:
    inv = ~valid_t
    covered = 1
    cur = inv
    while covered < k:
        step = min(covered, k - covered)
        cur = cur[: cur.shape[0] - step] | cur[step:]
        covered += step
    P = valid_t.shape[0] - k + 1
    return ~cur[:P]


def extract_kmer_lanes_t(
    codes_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    k: int,
    canonical: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transposed twin of extract_kmer_lanes: ``[L, R]`` codes/valid →
    (lanes ``[NLa, P, R] uint32``, window_valid ``[P, R] bool``)."""
    L, R = codes_t.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"line length {L} shorter than k={k}")
    A = _pack_tree_t(codes_t)
    lanes = _fwd_lanes_t(A, k, P)
    if canonical:
        lanes = _lex_min(_rc_lanes_t(A, k, P), lanes)
    wvalid = _window_valid_t(valid_t, k)
    return jnp.stack(lanes, axis=0), wvalid
