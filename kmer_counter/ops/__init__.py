"""Device compute ops (JAX/XLA).

Replacements for the reference's CUDA stages (GPUHandler.cu):

  bitEncode (GPUHandler.cu:10-111)      → ops.encode.encode_reads
  extractKMers (GPUHandler.cu:129-233)  → ops.extract.extract_kmer_lanes
  sortKmers (GPUHandler.cu:300-327, dormant) +
  reduceKMers (GPUHandler.cu:340-360)   → ops.sortcount.sort_reduce
  host TBB hash aggregation (KMerCounter.cpp:51-89) →
    ops.table / ops.table2 (device-resident sorted accumulation tables)
"""

from kmer_counter.ops.encode import encode_reads
from kmer_counter.ops.extract import extract_kmer_lanes
from kmer_counter.ops.sortcount import sort_reduce
from kmer_counter.ops.pipeline import count_chunk, extract_chunk

__all__ = [
    "encode_reads",
    "extract_kmer_lanes",
    "sort_reduce",
    "count_chunk",
    "extract_chunk",
]
