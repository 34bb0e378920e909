"""Shared utilities: synthetic sequence/FASTQ generation (utils.seqgen)."""

from kmer_counter.utils.seqgen import random_genome, sample_reads, write_fastq_file

__all__ = ["random_genome", "sample_reads", "write_fastq_file"]
