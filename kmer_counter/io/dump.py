"""Binary count-table dump in the reference record format.

Replaces DumpResults (KMerCounter.cpp:91-106) and FileDump
(FileDump.cpp:51-58).  Two documented reference defects are fixed
(SURVEY.md §7.1): all ``ceil(k/32)`` key words are written (the reference
hardcodes 8 key bytes, truncating k>32 — KMerCounter.cpp:102), and records
are written globally sorted ascending (the dormant merge pipeline's
intended output) rather than in hash-iteration order.
"""

from __future__ import annotations

import os

import numpy as np

from kmer_counter import records


def dump_table(
    path: str,
    lanes: np.ndarray,
    counts: np.ndarray,
    num_unique: int | None = None,
    append: bool = False,
) -> int:
    """Write a (lanes, counts) table as reference-format records.

    ``lanes`` is the device layout ``[N, NL] uint32``; rows past
    ``num_unique`` (or with count 0) are skipped.  Returns records written.
    """
    lanes = np.asarray(lanes)
    counts = np.asarray(counts)
    if num_unique is not None:
        lanes = lanes[:num_unique]
        counts = counts[:num_unique]
    keep = counts > 0
    if not keep.all():
        lanes, counts = lanes[keep], counts[keep]
    words = records.lanes_to_words(lanes)
    data = records.serialize_table(words, counts)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "ab" if append else "wb") as fh:
        fh.write(data)
    return len(counts)


def load_table(path: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Read a record file back as (words [U, W] uint64, counts [U] uint32)."""
    with open(path, "rb") as fh:
        return records.parse_records(fh.read(), k)
