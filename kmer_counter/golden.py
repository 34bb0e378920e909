"""Golden-model k-mer counter — the test oracle.

A deliberately simple dict-based counter implementing the behavioral contract
of the reference pipeline (SURVEY.md §7.1): per read, every window of k
consecutive *valid* bases contributes one count; windows overlapping an
invalid base are skipped (GPUHandler.cu:79-87, 169-172); k-mers never cross
read boundaries (one CUDA thread per read, GPUHandler.cu:129-233).  With
``canonical=True`` the key is min(kmer, revcomp) — the correctness target of
BASELINE.json configs 2/5; ``canonical=False`` replicates the reference's
forward-strand-only semantics.

The device engine in ``ops``/``parallel`` must match this model exactly.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from kmer_counter import records


def count_reads(
    reads, k: int, canonical: bool = False
) -> "Counter[tuple[int, ...]]":
    """Count k-mers over an iterable of reads.

    ``reads`` may be an iterable of strings/bytes, or a 2-D uint8 ASCII
    array of shape [R, L].  Returns Counter mapping key-word tuples
    (ints, ``words_per_kmer(k)`` long) to counts.
    """
    counts: Counter[tuple[int, ...]] = Counter()
    for read in reads:
        if isinstance(read, str):
            arr = np.frombuffer(read.encode("ascii"), dtype=np.uint8)
        elif isinstance(read, (bytes, bytearray)):
            arr = np.frombuffer(bytes(read), dtype=np.uint8)
        else:
            arr = np.asarray(read, dtype=np.uint8)
        L = arr.shape[0]
        if L < k:
            continue
        codes, valid = records.encode_bases(arr)
        # All windows at once: windows [P, k] of codes; window valid iff all
        # its bases are valid.
        P = L - k + 1
        idx = np.arange(P)[:, None] + np.arange(k)[None, :]
        win_codes = codes[idx]
        win_valid = valid[idx].all(axis=1)
        if not win_valid.any():
            continue
        words = records.pack_codes(win_codes[win_valid], k)
        if canonical:
            words = records.canonical_words(words, k)
        for key in map(tuple, words.tolist()):
            counts[key] += 1
    return counts


def table_from_counter(counter) -> tuple[np.ndarray, np.ndarray]:
    """Counter → (sorted keys [U, W] uint64, counts [U] uint32).

    Sorted ascending by key words — the globally-sorted dump order the
    dormant reference merge pipeline was designed to produce
    (SURVEY.md §7.1, BASELINE.json:5).
    """
    if not counter:
        return np.zeros((0, 1), dtype=np.uint64), np.zeros(0, dtype=np.uint32)
    keys = sorted(counter.keys())
    words = np.array(keys, dtype=np.uint64)
    counts = np.array([counter[key] for key in keys], dtype=np.uint32)
    return words, counts


def serialize_counter(counter) -> bytes:
    """Counter → reference record bytes, globally sorted."""
    words, counts = table_from_counter(counter)
    return records.serialize_table(words, counts)


# ---- vectorized NumPy reference -----------------------------------------
#
# The same contract as count_reads, at the sizes a real run counts (tens of
# millions of windows): every window is packed straight into uint64 key
# words, canonical keys are the word-wise minimum of forward and reverse
# complement, and a NumPy sort does the counting.  It shares nothing with
# ops/ or parallel/ (only records' ABI helpers), so the device engine can be
# checked byte for byte against it on the card.

_BLOCK_READS = 1 << 16


def _window_words(codes: np.ndarray, k: int) -> np.ndarray:
    """codes ``[R, L]`` uint64 (0..3) → key words ``[W, R, P]`` of every
    window, MSB-first, zero tail."""
    R, L = codes.shape
    P = L - k + 1
    out = np.zeros((records.words_per_kmer(k), R, P), np.uint64)
    tmp = np.empty((R, P), np.uint64)
    for j in range(k):
        w, b = divmod(j, records.BASES_PER_WORD)
        np.left_shift(codes[:, j : j + P], np.uint64(62 - 2 * b), out=tmp)
        np.bitwise_or(out[w], tmp, out=out[w])
    return out


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise lexicographic a < b over the leading (word) axis."""
    less = np.zeros(a.shape[1:], bool)
    equal = np.ones(a.shape[1:], bool)
    for w in range(a.shape[0]):
        less |= equal & (a[w] < b[w])
        equal &= a[w] == b[w]
    return less


def window_keys(reads: np.ndarray, k: int, canonical: bool = False) -> np.ndarray:
    """Key words ``[N, W]`` uint64 of every valid window of a dense
    ``[R, L]`` uint8 ASCII read block (windows touching a non-ACGT base
    are skipped; reads shorter than k give none)."""
    reads = np.asarray(reads, np.uint8)
    R, L = reads.shape
    W = records.words_per_kmer(k)
    if L < k or R == 0:
        return np.zeros((0, W), np.uint64)
    codes, valid = records.encode_bases(reads)
    codes = codes.astype(np.uint64)
    bad = np.zeros((R, L + 1), np.int32)
    np.cumsum(~valid, axis=1, out=bad[:, 1:])
    wvalid = bad[:, k:] == bad[:, : L - k + 1]
    words = _window_words(codes, k)
    if canonical:
        rc = _window_words((np.uint64(3) - codes)[:, ::-1], k)[:, :, ::-1]
        words = np.where(_lex_less(rc, words)[None], rc, words)
    return words.transpose(1, 2, 0)[wvalid]


def numpy_count_table(blocks, k: int, canonical: bool = False):
    """(sorted keys ``[U, W]`` uint64, counts ``[U]`` uint32) over an
    iterable of ``[R, L]`` uint8 read blocks."""
    keys = [window_keys(b, k, canonical) for b in blocks]
    keys = np.concatenate(keys) if keys else np.zeros((0, 1), np.uint64)
    if keys.shape[0] == 0:
        return np.zeros((0, records.words_per_kmer(k)), np.uint64), np.zeros(
            0, np.uint32
        )
    if keys.shape[1] == 1:
        uniq, counts = np.unique(keys[:, 0], return_counts=True)
        return uniq[:, None], counts.astype(np.uint32)
    # Multi-word keys: np.unique(axis=0) does not order rows numerically
    # word by word, so sort with lexsort (last key = most significant).
    keys = keys[np.lexsort(keys.T[::-1])]
    head = np.concatenate([[True], (keys[1:] != keys[:-1]).any(axis=1)])
    starts = np.flatnonzero(head)
    counts = np.diff(np.append(starts, keys.shape[0]))
    return keys[starts], counts.astype(np.uint32)


def fastq_blocks(dirpath: str, block_reads: int = _BLOCK_READS):
    """Dense ``[R, L]`` uint8 sequence blocks of every 4-line FASTQ file
    in a directory (sorted names; reads grouped by length)."""
    import os

    for name in sorted(os.listdir(dirpath)):
        path = os.path.join(dirpath, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as fh:
            seqs = fh.read().split(b"\n")[1::4]
        by_len: dict[int, list[bytes]] = {}
        for s in seqs:
            s = s.rstrip(b"\r")
            by_len.setdefault(len(s), []).append(s)
        for L, group in sorted(by_len.items()):
            for i in range(0, len(group), block_reads):
                part = group[i : i + block_reads]
                yield np.frombuffer(b"".join(part), np.uint8).reshape(len(part), L)


def numpy_reference_dump(dirpath: str, k: int, canonical: bool = False) -> bytes:
    """The expected output file of a count over a FASTQ directory, in the
    reference record format."""
    words, counts = numpy_count_table(fastq_blocks(dirpath), k, canonical)
    return records.serialize_table(words, counts)
