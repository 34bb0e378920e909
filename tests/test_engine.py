"""End-to-end engine tests: FASTQ directory → sorted binary count table."""

import numpy as np
import pytest

from kmer_counter import golden, records
from kmer_counter.config import Options
from kmer_counter.engine import CountEngine, plan_chunks
from kmer_counter.io.dump import load_table

from test_ingest import random_seqs, write_fastq


def run_engine(tmp_path, k, canonical=False, **kw):
    out = str(tmp_path / "output.bin")
    opts = Options(
        kmer_length=k,
        canonical=canonical,
        input_dir=str(tmp_path / "in"),
        output_file=out,
        verbose=0,
        **kw,
    )
    stats = CountEngine(opts).run()
    return load_table(out, k), stats


def golden_dir_table(tmp_path, k, canonical=False):
    import os

    counter = {}
    dirpath = tmp_path / "in"
    for name in sorted(os.listdir(dirpath)):
        with open(dirpath / name) as fh:
            lines = fh.read().splitlines()
        seqs = [lines[i] for i in range(1, len(lines), 4)]
        for key, c in golden.count_reads(seqs, k, canonical).items():
            counter[key] = counter.get(key, 0) + c
    return golden.table_from_counter(counter)


@pytest.mark.parametrize("k,canonical", [(15, False), (31, True), (55, False)])
def test_engine_matches_golden(tmp_path, rng, k, canonical):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 37, 70))
    (words, counts), stats = run_engine(
        tmp_path, k, canonical, reads_per_chunk=8
    )
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 37
    assert stats.total_kmers == int(want_counts.sum())
    assert stats.distinct_kmers == len(want_words)


def test_engine_multi_file_merged_counts(tmp_path, rng):
    # BASELINE.json config 3: multi-file input, merged global counts.
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 10, 50)
    # Same reads in two files => counts double, plus a third distinct file.
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    write_fastq(tmp_path / "in" / "b.fastq", seqs)
    write_fastq(tmp_path / "in" / "c.fastq", random_seqs(rng, 5, 50))
    (words, counts), stats = run_engine(tmp_path, 15, reads_per_chunk=4)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 25


def test_engine_invalid_bases(tmp_path, rng):
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 20, 40, alphabet="ACGTN")
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    (words, counts), _ = run_engine(tmp_path, 9)
    want_words, want_counts = golden_dir_table(tmp_path, 9)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_engine_tiny_table_forces_consolidations(tmp_path, rng):
    # Small table capacity exercises consolidate + grow under pressure.
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 64, 40))
    (words, counts), stats = run_engine(
        tmp_path, 15, reads_per_chunk=4, table_slots=600
    )
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.consolidations > 1


@pytest.mark.parametrize("k,canonical", [(15, False), (31, True)])
def test_engine_two_level_matches_golden(tmp_path, rng, k, canonical):
    # tableImpl=two drives the two-level loop (consolidate2 merges).
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 37, 70))
    (words, counts), stats = run_engine(
        tmp_path, k, canonical, reads_per_chunk=8, table_impl="two"
    )
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.total_kmers == int(want_counts.sum())


def test_engine_two_level_grow_under_pressure(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 64, 40))
    (words, counts), stats = run_engine(
        tmp_path, 15, reads_per_chunk=4, table_slots=600, table_impl="two"
    )
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.consolidations > 1


def test_engine_two_level_spill(tmp_path, rng):
    # Tiny budget + a temp dir: the two-level engine must spill sorted
    # runs and host-merge them (config 4 analog).
    (tmp_path / "in").mkdir()
    (tmp_path / "tmpdir").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 96, 40))
    (words, counts), stats = run_engine(
        tmp_path,
        15,
        reads_per_chunk=8,
        table_slots=512,
        table_impl="two",
        temp_dir=str(tmp_path / "tmpdir"),
    )
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.spilled_runs >= 2


def test_engine_mixed_line_lengths(tmp_path, rng):
    # Files of different read lengths trigger a shape change mid-run.
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 10, 40))
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 10, 60))
    (words, counts), _ = run_engine(tmp_path, 15, reads_per_chunk=4)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_engine_short_file_skipped(tmp_path, rng):
    # A file whose reads are shorter than k contributes nothing.
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 5, 10))
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 8, 40))
    (words, counts), stats = run_engine(tmp_path, 15, reads_per_chunk=4)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    assert stats.reads == 13


def test_plan_chunks_budget():
    opts = Options(kmer_length=31, memory_limit_bytes=100_000_000)
    reads_per_chunk, table_slots = plan_chunks(opts, line_length=100)
    assert reads_per_chunk >= 16
    # table bytes within ~budget/2
    assert table_slots * 3 * 4 <= opts.memory_limit_bytes
    with pytest.raises(ValueError):
        plan_chunks(opts, line_length=20)


def test_engine_profile_trace(tmp_path, rng, monkeypatch):
    # profile=true wraps the run in a jax.profiler trace written next to
    # the output; just verify the trace directory materializes.
    import jax

    if jax.default_backend() != "cpu":
        pytest.skip("profiler smoke test runs on CPU")
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 6, 30))
    out = str(tmp_path / "out.bin")
    from kmer_counter.engine import run_count

    opts = Options(
        kmer_length=9,
        input_dir=str(tmp_path / "in"),
        output_file=out,
        profile=True,
        verbose=0,
    )
    stats = run_count(opts)
    assert stats.reads == 6
    import os

    assert os.path.isdir(out + ".trace")


def test_engine_k128_end_to_end(tmp_path, rng):
    # Largest supported k (4-word keys, reference envelope GPUHandler.cu:300-327).
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 6, 140))
    (words, counts), stats = run_engine(tmp_path, 128, reads_per_chunk=4)
    want_words, want_counts = golden_dir_table(tmp_path, 128)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert words.shape[1] == 4
