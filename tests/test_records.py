"""Unit tests for the k-mer record ABI (kmer_counter.records).

Hand vectors pin the exact reference byte format (SURVEY.md §2.2): MSB-first
2-bit packing into uint64 words, little-endian storage, uint32 count.
"""

import numpy as np
import pytest

from kmer_counter import records


def test_sizes():
    assert records.words_per_kmer(1) == 1
    assert records.words_per_kmer(32) == 1
    assert records.words_per_kmer(33) == 2
    assert records.words_per_kmer(64) == 2
    assert records.words_per_kmer(65) == 3
    assert records.words_per_kmer(128) == 4
    assert records.record_size_bytes(31) == 12
    assert records.record_size_bytes(55) == 20
    with pytest.raises(ValueError):
        records.words_per_kmer(0)
    with pytest.raises(ValueError):
        records.words_per_kmer(129)


def test_encode_bases():
    codes, valid = records.encode_bases(np.frombuffer(b"ACGTacgtNX", dtype=np.uint8))
    np.testing.assert_array_equal(codes, [0, 1, 2, 3, 0, 1, 2, 3, 3, 3])
    np.testing.assert_array_equal(valid, [True] * 8 + [False, False])


def test_pack_hand_vector_msb_first():
    # "CA" at k=2: base0=C=01 in bits 63-62, base1=A=00 in bits 61-60.
    words = records.pack_codes(np.array([1, 0]), k=2)
    assert words.shape == (1,)
    assert words[0] == np.uint64(0x4000_0000_0000_0000)
    # "T" at k=1: T=11 in bits 63-62.
    assert records.pack_codes(np.array([3]), k=1)[0] == np.uint64(0xC000_0000_0000_0000)
    # All-A is zero.
    assert records.pack_codes(np.zeros(32, dtype=int), k=32)[0] == 0


def test_pack_full_word_and_tail_zero():
    # 32 T's fill word 0 with all ones.
    w = records.pack_codes(np.full(33, 3), k=33)
    assert w.shape == (2,)
    assert w[0] == np.uint64(0xFFFF_FFFF_FFFF_FFFF)
    # base 32 = T in bits 63-62 of word 1, rest zero tail.
    assert w[1] == np.uint64(0xC000_0000_0000_0000)


def test_pack_unpack_roundtrip(rng):
    for k in (1, 5, 15, 16, 31, 32, 33, 55, 64, 65, 96, 128):
        codes = rng.integers(0, 4, size=(7, k)).astype(np.uint8)
        words = records.pack_codes(codes, k)
        assert words.shape == (7, records.words_per_kmer(k))
        np.testing.assert_array_equal(records.unpack_words(words, k), codes)


def test_numeric_order_is_lexicographic(rng):
    # MSB-first packing => uint64 word order == base lexicographic order.
    k = 31
    codes = rng.integers(0, 4, size=(200, k)).astype(np.uint8)
    words = records.pack_codes(codes, k)[:, 0]
    by_words = np.argsort(words, kind="stable")
    as_strings = ["".join(records.CODE_TO_BASE[c] for c in row) for row in codes]
    by_string = np.argsort(np.array(as_strings), kind="stable")
    np.testing.assert_array_equal(
        np.array(as_strings)[by_words], np.array(as_strings)[by_string]
    )


def test_lanes_roundtrip_and_order(rng):
    k = 55
    codes = rng.integers(0, 4, size=(100, k)).astype(np.uint8)
    words = records.pack_codes(codes, k)
    lanes = records.words_to_lanes(words)
    assert lanes.shape == (100, 4)
    np.testing.assert_array_equal(records.lanes_to_words(lanes), words)
    # Lexicographic order over uint32 lanes == order over uint64 words.
    order_words = sorted(map(tuple, words.tolist()))
    order_lanes = [
        tuple(records.lanes_to_words(np.array(t, dtype=np.uint32)).tolist())
        for t in sorted(map(tuple, lanes.tolist()))
    ]
    assert order_lanes == order_words


def test_revcomp_and_canonical():
    # revcomp("ACGT") == "ACGT" (palindrome); revcomp("AAAA") == "TTTT".
    k = 4
    acgt = records.pack_codes(np.array([0, 1, 2, 3]), k)
    np.testing.assert_array_equal(records.revcomp_words(acgt, k), acgt)
    aaaa = records.pack_codes(np.zeros(4, dtype=int), k)
    tttt = records.pack_codes(np.full(4, 3), k)
    np.testing.assert_array_equal(records.revcomp_words(aaaa, k), tttt)
    # canonical picks the smaller: AAAA for both AAAA and TTTT.
    np.testing.assert_array_equal(records.canonical_words(tttt, k), aaaa)
    np.testing.assert_array_equal(records.canonical_words(aaaa, k), aaaa)


def test_revcomp_involution(rng):
    for k in (15, 31, 33, 55):
        codes = rng.integers(0, 4, size=(50, k)).astype(np.uint8)
        words = records.pack_codes(codes, k)
        np.testing.assert_array_equal(
            records.revcomp_words(records.revcomp_words(words, k), k), words
        )


def test_serialize_parse_roundtrip(rng):
    for k in (15, 31, 55, 128):
        W = records.words_per_kmer(k)
        codes = rng.integers(0, 4, size=(20, k)).astype(np.uint8)
        words = records.pack_codes(codes, k)
        counts = rng.integers(1, 1000, size=20).astype(np.uint32)
        data = records.serialize_table(words, counts)
        assert len(data) == 20 * records.record_size_bytes(k)
        w2, c2 = records.parse_records(data, k)
        np.testing.assert_array_equal(w2, words)
        np.testing.assert_array_equal(c2, counts)


def test_serialize_little_endian_layout():
    # One record, k=3 ("CAT"): C=01 A=00 T=11 -> bits 63-58 = 010011.
    words = records.pack_codes(np.array([1, 0, 3]), k=3)
    data = records.serialize_table(words.reshape(1, 1), np.array([7], np.uint32))
    assert len(data) == 12
    value = int.from_bytes(data[:8], "little")
    assert value == (0b010011 << 58)
    assert int.from_bytes(data[8:], "little") == 7


def test_kmer_to_string_print_parity():
    # The reference printer renders all 32 bases per word incl. zero tail
    # as 'A's (KMerPrinter.cpp:68-91).
    words = records.pack_codes(np.array([1, 0, 3]), k=3)
    assert records.kmer_to_string(words) == "CAT" + "A" * 29
    assert records.kmer_to_string(words, k=3) == "CAT"
