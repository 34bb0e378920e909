"""Adversarial edge cases across the device pipeline."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmer_counter import golden, records
from kmer_counter.ops import count_chunk

from test_ops import table_to_counter


def reads_from_strings(seqs):
    L = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    return out


@pytest.mark.parametrize("k", [1, 2, 128])
def test_extreme_k(k):
    rng = np.random.default_rng(3)
    L = max(k + 3, 8)
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(4)]
    reads = reads_from_strings(seqs)
    lanes, counts, n = count_chunk(jnp.asarray(reads), k, False)
    assert table_to_counter(lanes, counts, n, k) == dict(
        golden.count_reads(seqs, k)
    )


def test_poly_a_canonical():
    # poly-A reads: every window is AAAA..A; canonical(AA..A) = AA..A;
    # massive duplication in a single key.
    seqs = ["A" * 50] * 8
    reads = reads_from_strings(seqs)
    lanes, counts, n = count_chunk(jnp.asarray(reads), 15, True)
    got = table_to_counter(lanes, counts, n, 15)
    assert got == {(0,): 8 * (50 - 15 + 1)}


def test_poly_t_canonical_maps_to_poly_a():
    seqs = ["T" * 40] * 3
    reads = reads_from_strings(seqs)
    lanes, counts, n = count_chunk(jnp.asarray(reads), 9, True)
    got = table_to_counter(lanes, counts, n, 9)
    assert got == {(0,): 3 * 32}


def test_all_n_reads():
    seqs = ["N" * 30] * 5
    reads = reads_from_strings(seqs)
    lanes, counts, n = count_chunk(jnp.asarray(reads), 9, False)
    assert int(n) == 0
    assert int(np.asarray(counts).sum()) == 0


def test_all_t_forward_not_confused_with_sentinel():
    # forward-strand all-T k-mers share bit patterns with the internal
    # all-ones sentinel; their counts must still be exact.
    seqs = ["T" * 33, "T" * 33, "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTG"]
    reads = reads_from_strings(seqs)
    k = 33
    lanes, counts, n = count_chunk(jnp.asarray(reads), k, False)
    got = table_to_counter(lanes, counts, n, k)
    want = dict(golden.count_reads(seqs, k))
    assert got == want


def test_mixed_case_reads():
    seqs = ["acgtACGTacgt", "AcGtAcGtAcGt"]
    reads = reads_from_strings(seqs)
    lanes, counts, n = count_chunk(jnp.asarray(reads), 5, False)
    got = table_to_counter(lanes, counts, n, 5)
    assert got == dict(golden.count_reads([s.upper() for s in seqs], 5))
