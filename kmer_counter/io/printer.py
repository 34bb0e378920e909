"""Binary record file → human-readable text (KMerPrinter analog).

Reproduces the reference ``print`` CLI mode's exact text rendering
(KMerPrinter.cpp:35-91): records are streamed in 10,000-record chunks,
every 64-bit key word is printed as 32 bases MSB-first *including* the
zero-padding tail (which renders as 'A's), followed by a space and the
uint32 count.  The reference accepts an output filename but always writes
to stdout (KMerPrinter.cpp:13-16,35 — "accepted but never used"); here the
stream is an explicit parameter so it is actually honored when given.
"""

from __future__ import annotations

import sys
from typing import TextIO

from kmer_counter import records

_RECORDS_PER_CHUNK = 10_000  # KMerPrinter.cpp:26


def print_records(
    input_path: str,
    k: int,
    out: TextIO | None = None,
    trim: bool = False,
) -> int:
    """Render a record file as text; returns the number of records printed.

    ``trim=False`` reproduces the reference's all-32-bases-per-word output
    (KMerPrinter.cpp:68-91); ``trim=True`` prints only the true k bases.
    """
    out = out if out is not None else sys.stdout
    rec_size = records.record_size_bytes(k)
    chunk_bytes = rec_size * _RECORDS_PER_CHUNK
    n = 0
    with open(input_path, "rb") as fh:
        while True:
            data = fh.read(chunk_bytes)
            if not data:
                break
            words, counts = records.parse_records(data, k)
            keff = None if not trim else k
            for row, count in zip(words, counts):
                out.write(f"{records.kmer_to_string(row, keff)} {count}\n")
                n += 1
    return n
