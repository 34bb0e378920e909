"""kmer_counter — a k-mer counting engine in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the reference
CUDA k-mer counter (jsdjayanga/kmer-counter): FASTQ reads are streamed
data-parallel, 2-bit packed on device, and (optionally canonical) k-mers are
extracted and counted via sorted-segment reduction, with per-device partial
count tables range-partitioned by k-mer prefix and merged with all-to-all
collectives over a ``jax.sharding.Mesh`` — subsuming the reference's
external-memory disk-merge pipeline (KMerFileMerger/SortedKMerFile) in HBM.

Component map (reference file → this package; see SURVEY.md §2):

  main.cpp (CLI)                     → kmer_counter.__main__
  Options.{h,cpp}                    → kmer_counter.config
  KMerCounter.{h,cpp} (orchestrator) → kmer_counter.engine
  InputFileHandler / FASTQFileReader
    / FASTQData                      → kmer_counter.io.fastq (+ native/)
  GPUHandler.cu bitEncode            → kmer_counter.ops.encode
  GPUHandler.cu extractKMers         → kmer_counter.ops.extract
  GPUHandler.cu sortKmers+reduceKMers→ kmer_counter.ops.sortcount
  KMerSizes.h (record structs)       → kmer_counter.records
  KMerFileMergeHandler / KMerFileMerger
    / SortedKMerFile (disk merge)    → kmer_counter.parallel.shuffle (HBM)
                                       + kmer_counter.io.spill (host path)
  FileDump                           → kmer_counter.io.dump
  KMerPrinter                        → kmer_counter.io.printer
"""

from kmer_counter.config import Options
from kmer_counter import records

__version__ = "0.1.0"

__all__ = ["Options", "records", "__version__"]
