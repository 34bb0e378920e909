"""Device-op tests: encode/extract/sort-count vs the golden model."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmer_counter import golden, records
from kmer_counter.ops import (
    count_chunk,
    encode_reads,
    extract_kmer_lanes,
    sort_reduce,
)
from kmer_counter.ops import table as table_ops


def table_to_counter(lanes, counts, num_unique, k):
    lanes = np.asarray(lanes)[:, : int(num_unique)].T  # lane-major device layout
    counts = np.asarray(counts)[: int(num_unique)]
    words = records.lanes_to_words(lanes)
    return {tuple(w): int(c) for w, c in zip(words.tolist(), counts.tolist())}


def test_encode_reads_matches_host():
    data = np.frombuffer(b"ACGTacgtNX\x00Z", dtype=np.uint8).reshape(2, 6)
    codes, valid = encode_reads(jnp.asarray(data))
    host_codes, host_valid = records.encode_bases(data)
    np.testing.assert_array_equal(np.asarray(codes), host_codes)
    np.testing.assert_array_equal(np.asarray(valid), host_valid)


@pytest.mark.parametrize("k", [4, 15, 16, 17, 31, 32, 33, 55, 64, 65, 128])
def test_extract_matches_host_pack(rng, k):
    L = max(k + 9, 40)
    reads = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(3, L))
    codes, valid = encode_reads(jnp.asarray(reads))
    lanes, wvalid = extract_kmer_lanes(codes, valid, k)
    P = L - k + 1
    assert lanes.shape == (records.active_lanes(k), 3, P)
    assert bool(np.asarray(wvalid).all())
    host_codes, _ = records.encode_bases(reads)
    for r in range(3):
        for p in range(P):
            want = records.words_to_lanes(
                records.pack_codes(host_codes[r, p : p + k], k)
            )[: records.active_lanes(k)]
            np.testing.assert_array_equal(np.asarray(lanes[:, r, p]), want)


def test_extract_validity_mask():
    reads = np.frombuffer(b"ACGTNACGTA", dtype=np.uint8).reshape(1, 10)
    codes, valid = encode_reads(jnp.asarray(reads))
    _, wvalid = extract_kmer_lanes(codes, valid, 4)
    # windows starting at 0: ACGT ok; 1-4 cover the N; 5,6: ACGT/CGTA ok.
    np.testing.assert_array_equal(
        np.asarray(wvalid)[0], [True, False, False, False, False, True, True]
    )


@pytest.mark.parametrize("k", [15, 31, 33])
def test_extract_canonical(rng, k):
    L = k + 5
    reads = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(2, L))
    codes, valid = encode_reads(jnp.asarray(reads))
    lanes, _ = extract_kmer_lanes(codes, valid, k, canonical=True)
    host_codes, _ = records.encode_bases(reads)
    for r in range(2):
        for p in range(L - k + 1):
            fwd = records.pack_codes(host_codes[r, p : p + k], k)
            want = records.words_to_lanes(records.canonical_words(fwd, k))[
                : records.active_lanes(k)
            ]
            np.testing.assert_array_equal(np.asarray(lanes[:, r, p]), want)


def test_sort_reduce_basic():
    # keys: b, a, b, empty, a, a  (2-lane)
    a = [1, 2]
    b = [1, 3]
    lanes = jnp.asarray(np.array([b, a, b, [0, 0], a, a], dtype=np.uint32).T)
    counts = jnp.asarray(np.array([1, 1, 5, 0, 2, 1], dtype=np.uint32))
    u_lanes, u_counts, n = sort_reduce(lanes, counts)
    assert int(n) == 2
    np.testing.assert_array_equal(np.asarray(u_lanes[:, :2].T), [a, b])
    np.testing.assert_array_equal(np.asarray(u_counts[:2]), [4, 6])
    np.testing.assert_array_equal(np.asarray(u_counts[2:]), 0)


def test_sort_reduce_all_empty():
    lanes = jnp.zeros((2, 8), dtype=jnp.uint32)
    counts = jnp.zeros((8,), dtype=jnp.uint32)
    _, u_counts, n = sort_reduce(lanes, counts)
    assert int(n) == 0
    np.testing.assert_array_equal(np.asarray(u_counts), 0)


def test_sort_reduce_sorted_unsigned():
    # Keys with the high bit set must sort after small keys (unsigned order).
    lanes = jnp.asarray(np.array([[0x8000_0000, 1, 0x7FFF_FFFF]], np.uint32))
    counts = jnp.ones((3,), jnp.uint32)
    u_lanes, _, n = sort_reduce(lanes, counts)
    assert int(n) == 3
    np.testing.assert_array_equal(
        np.asarray(u_lanes[0]), [1, 0x7FFF_FFFF, 0x8000_0000]
    )


@pytest.mark.parametrize("k", [4, 15, 31, 33, 55, 128])
@pytest.mark.parametrize("canonical", [False, True])
def test_count_chunk_matches_golden(make_reads, k, canonical):
    L = max(k + 10, 50)
    reads = make_reads(16, L, invalid_frac=0.05)
    lanes, counts, n = count_chunk(jnp.asarray(reads), k, canonical)
    got = table_to_counter(lanes, counts, n, k)
    want = {key: c for key, c in golden.count_reads(reads, k, canonical).items()}
    assert got == want
    # Keys come out sorted ascending.
    keys = list(map(tuple, np.asarray(lanes[:, : int(n)].T).tolist()))
    assert keys == sorted(keys)


def test_count_chunk_zero_padded_rows(make_reads):
    # Rows padded with zero bytes (invalid) contribute nothing — unlike the
    # reference, whose section zero-padding leaked pseudo-records into the
    # hash table (SURVEY.md §7.1).
    reads = make_reads(4, 30)
    padded = np.vstack([reads, np.zeros((3, 30), dtype=np.uint8)])
    l1, c1, n1 = count_chunk(jnp.asarray(reads), 15, False)
    l2, c2, n2 = count_chunk(jnp.asarray(padded), 15, False)
    assert table_to_counter(l1, c1, n1, 15) == table_to_counter(l2, c2, n2, 15)


def test_table_append_consolidate(make_reads):
    k = 15
    chunks = [make_reads(8, 40) for _ in range(5)]
    N = 8 * (40 - k + 1)
    capacity = 4 * N
    table = table_ops.make_table(capacity=capacity, num_lanes=2)
    host_bound = 0
    want = {}
    for chunk in chunks:
        for key, c in golden.count_reads(chunk, k).items():
            want[key] = want.get(key, 0) + c
        if host_bound + N > capacity:
            table = table_ops.consolidate(table)
            host_bound = int(table.offset)
            if host_bound + N > capacity:
                # consolidation freed nothing (all keys distinct): grow,
                # as the engine does.
                capacity = 2 * (host_bound + N)
                table = table_ops.grow(table, capacity)
        lanes, counts, n = count_chunk(jnp.asarray(chunk), k, False)
        table = table_ops.append(table, lanes, counts, n)
        host_bound += N
    table = table_ops.consolidate(table)
    got = table_to_counter(table.lanes, table.counts, table.offset, k)
    assert got == want


def test_table_grow(make_reads):
    k = 15
    chunk = make_reads(4, 30)
    N = 4 * (30 - k + 1)
    table = table_ops.make_table(capacity=N, num_lanes=2)
    lanes, counts, n = count_chunk(jnp.asarray(chunk), k, False)
    table = table_ops.append(table, lanes, counts, n)
    grown = table_ops.grow(table, capacity=2 * N)
    grown = table_ops.consolidate(grown)
    want = dict(golden.count_reads(chunk, k))
    assert table_to_counter(grown.lanes, grown.counts, grown.offset, k) == want
