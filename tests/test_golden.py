"""Tests for the golden-model counter itself (the oracle must be right)."""

import numpy as np
import pytest

from kmer_counter import golden, records


def brute_force(reads, k, canonical=False):
    """An even dumber counter: pure string ops."""
    from collections import Counter

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    counts = Counter()
    for read in reads:
        read = read.upper()
        for i in range(len(read) - k + 1):
            window = read[i : i + k]
            if any(c not in "ACGT" for c in window):
                continue
            if canonical:
                rc = "".join(comp[c] for c in reversed(window))
                window = min(window, rc)
            counts[window] += 1
    return counts


def as_strings(counter, k):
    return {
        records.kmer_to_string(np.array(key, dtype=np.uint64), k): v
        for key, v in counter.items()
    }


def test_golden_simple():
    counts = golden.count_reads(["ACGTACGT"], k=4)
    s = as_strings(counts, 4)
    assert s == {"ACGT": 2, "CGTA": 1, "GTAC": 1, "TACG": 1}


def test_golden_invalid_bases():
    counts = golden.count_reads(["ACGNACGT"], k=4)
    s = as_strings(counts, 4)
    # Windows covering the N are skipped (GPUHandler.cu:169-172 semantics).
    assert s == {"ACGT": 1}


def test_golden_short_read_skipped():
    assert golden.count_reads(["ACG"], k=4) == {}


def test_golden_vs_brute_force(rng):
    for k in (3, 15, 31, 33):
        for canonical in (False, True):
            reads = [
                "".join(rng.choice(list("ACGTN"), size=60, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
                for _ in range(20)
            ]
            got = as_strings(golden.count_reads(reads, k, canonical), k)
            want = dict(brute_force(reads, k, canonical))
            assert got == want


def test_golden_uint8_matrix_input(make_reads):
    reads = make_reads(10, 50, invalid_frac=0.05)
    from_matrix = golden.count_reads(reads, k=15)
    from_strings = golden.count_reads(
        [bytes(row).decode("ascii") for row in reads], k=15
    )
    assert from_matrix == from_strings


def test_table_sorted_and_serializable(rng):
    reads = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(10)]
    counter = golden.count_reads(reads, k=31)
    words, counts = golden.table_from_counter(counter)
    assert len(words) == len(counter)
    # sorted ascending by words
    keys = list(map(tuple, words.tolist()))
    assert keys == sorted(keys)
    data = golden.serialize_counter(counter)
    w2, c2 = records.parse_records(data, 31)
    np.testing.assert_array_equal(w2, words)
    np.testing.assert_array_equal(c2, counts)
    assert int(counts.sum()) == sum(counter.values())


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 15, 16, 31, 32, 33, 55, 64, 101, 128])
def test_numpy_reference_matches_count_reads(k, canonical):
    rng = np.random.default_rng(k)
    L = k + 25
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (24, L))]
    reads[rng.random(reads.shape) < 0.004] = ord("N")
    reads[3, :] = ord("T")  # an all-T read: the max key, and A^k canonically
    short = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (5, max(k - 1, 1)))]
    blocks = [reads[:10], reads[10:], short] if k > 1 else [reads]
    words, counts = golden.numpy_count_table(blocks, k, canonical)
    want = golden.count_reads(list(reads) + list(short if k > 1 else []), k, canonical)
    assert records.serialize_table(words, counts) == golden.serialize_counter(want)
    assert words.shape[1] == records.words_per_kmer(k)


def test_numpy_reference_dump_reads_fastq_dir(tmp_path):
    from kmer_counter.utils.seqgen import make_fastq_dir

    rng = np.random.default_rng(5)
    make_fastq_dir(str(tmp_path), rng, 40, 60, 2, 500, invalid_frac=0.01)
    seqs = []
    for name in sorted(p.name for p in tmp_path.iterdir()):
        seqs += (tmp_path / name).read_text().splitlines()[1::4]
    assert golden.numpy_reference_dump(str(tmp_path), 21, True) == (
        golden.serialize_counter(golden.count_reads(seqs, 21, True))
    )
