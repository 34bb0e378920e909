"""Host I/O: FASTQ ingest, record dump, text printer, spill-merge.

Reference components replaced here:
  InputFileHandler.{h,cpp} + FASTQFileReader.{h,cpp} + FASTQData.{h,cpp}
      → io.fastq (NumPy block parser; optional C++ fast path in io.native)
  FileDump.{h,cpp} + DumpResults (KMerCounter.cpp:91-106)
      → io.dump (full-width records, globally sorted — fixing the
        reference's 8-byte-key truncation, SURVEY.md §7.1)
  KMerPrinter.{h,cpp} → io.printer
  KMerFileMergeHandler/KMerFileMerger/SortedKMerFile (disk merge)
      → io.spill (host-RAM/disk sorted-run merge for beyond-HBM
        cardinality; the on-device path is parallel.shuffle)
"""

from kmer_counter.io.fastq import DirectoryInput, FASTQChunk, FASTQReader

__all__ = ["DirectoryInput", "FASTQChunk", "FASTQReader"]
