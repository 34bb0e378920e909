"""Tests for the synthetic FASTQ generator (utils.seqgen)."""

import os

import numpy as np

from kmer_counter.io.fastq import DirectoryInput
from kmer_counter.utils.seqgen import (
    make_fastq_dir,
    random_genome,
    sample_reads,
    write_fastq_file,
)


def test_sample_reads_come_from_genome(rng):
    genome = random_genome(rng, 500)
    reads = sample_reads(rng, genome, 20, 50)
    g = bytes(genome).decode()
    for row in reads:
        assert bytes(row).decode() in g


def test_sample_reads_invalid_noise(rng):
    genome = random_genome(rng, 1000)
    reads = sample_reads(rng, genome, 50, 80, invalid_frac=0.1)
    frac = (reads == ord("N")).mean()
    assert 0.05 < frac < 0.2


def test_write_and_reparse_roundtrip(tmp_path, rng):
    genome = random_genome(rng, 400)
    reads = sample_reads(rng, genome, 15, 40)
    write_fastq_file(str(tmp_path / "a.fastq"), reads)
    src = DirectoryInput(str(tmp_path))
    chunk = src.read_chunk(100)
    np.testing.assert_array_equal(chunk.reads[: chunk.n_reads], reads)


def test_make_fastq_dir(tmp_path, rng):
    n = make_fastq_dir(str(tmp_path / "d"), rng, 30, 25, n_files=3)
    assert n == 30
    assert len(os.listdir(tmp_path / "d")) == 3
