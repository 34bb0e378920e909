"""Host spill of sorted runs + hierarchical k-way merge.

The modernized form of the reference's dormant external-memory pipeline:
FileDump spill writes (FileDump.cpp:51-58), the background merge scheduler
(KMerFileMergeHandler.cpp:49-117), the linear-scan k-way merger
(KMerFileMerger.cpp:49-135) and the sorted-run streaming reader with
adjacent-duplicate pre-merge (SortedKMerFile.cpp:29-82).

Differences by design:
  * Runs are written in the standard record format (records.py §2.2) and
    are *globally sorted* — they come from consolidated device tables, so
    merging is a pure streaming operation.
  * The merger uses a heap over buffered readers (the reference scans all
    open files linearly per output record, KMerFileMerger.cpp:55-82).
  * The scheduler mirrors the reference's knobs: ``fan_in`` files per merge
    (noOfMergersAtOnce) and ``threads`` concurrent mergers
    (noOfMergeThreads), re-queueing intermediate outputs until one run
    remains (KMerFileMergeHandler.cpp:61-99).

This path only engages when the distinct-key table outgrows the HBM budget
(BASELINE.json config 4's "spill" scenario); the multi-chip merge path
(parallel.shuffle) stays entirely in HBM.
"""

from __future__ import annotations

import heapq
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from kmer_counter import records

_READ_RECORDS = 1 << 16  # records per buffered read (SortedKMerFile's 1M cache role)


class RunReader:
    """Streaming reader over one sorted run, pre-merging adjacent equal keys
    (SortedKMerFile.cpp:57-82 analog)."""

    def __init__(self, path: str, k: int):
        self.path = path
        self.k = k
        self._rec = records.record_size_bytes(k)
        self._fh = open(path, "rb")
        self._words: np.ndarray | None = None
        self._counts: np.ndarray | None = None
        self._pos = 0
        self._carry = None  # first raw record of the next key group
        self._fill()
        self._head = self._read_merged()

    def _fill(self):
        data = self._fh.read(self._rec * _READ_RECORDS)
        if not data:
            self._words, self._counts = None, None
            self._fh.close()
            return
        self._words, self._counts = records.parse_records(data, self.k)
        self._pos = 0

    def _raw(self):
        """Next raw (key, count) record, or None at EOF."""
        if self._words is None:
            return None
        kv = (
            tuple(self._words[self._pos].tolist()),
            int(self._counts[self._pos]),
        )
        self._pos += 1
        if self._pos >= len(self._words):
            self._fill()
        return kv

    def _read_merged(self):
        """Next (key, count) with adjacent duplicates pre-summed."""
        raw = self._carry if self._carry is not None else self._raw()
        self._carry = None
        if raw is None:
            return None
        key, count = raw
        while True:
            nxt = self._raw()
            if nxt is None:
                break
            if nxt[0] == key:
                count += nxt[1]
            else:
                self._carry = nxt
                break
        return key, count

    def peek(self):
        """Current merged (key, count) without consuming it."""
        return self._head

    def pop(self):
        out = self._head
        if out is not None:
            self._head = self._read_merged()
        return out


def write_run(path: str, lanes: np.ndarray, counts: np.ndarray) -> str:
    """Serialize a consolidated (sorted) device table shard as a run file."""
    words = records.lanes_to_words(np.asarray(lanes))
    keep = np.asarray(counts) > 0
    data = records.serialize_table(words[keep], np.asarray(counts)[keep])
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def merge_runs(
    paths: list[str], out_path: str, k: int, use_native: bool | None = None
) -> int:
    """Heap-based k-way merge of sorted runs; returns records written.

    Equal keys across runs have their counts summed (the tie-collection of
    KMerFileMerger.cpp:55-82).  Dispatches to the C++ merger
    (native/kmer_io.cpp kc_merge_runs) when built, unless
    ``use_native=False``."""
    if use_native is not False:
        from kmer_counter.io import native

        if native.available():
            return native.native_merge_runs(paths, out_path, k)
        if use_native:
            raise RuntimeError("native library not built (make -C native)")
    readers = [RunReader(p, k) for p in paths]
    heap = []
    for i, r in enumerate(readers):
        item = r.pop()
        if item is not None:
            heap.append((item[0], i, item[1]))
    heapq.heapify(heap)

    W = records.words_per_kmer(k)
    buf_words: list[tuple] = []
    buf_counts: list[int] = []
    written = 0

    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out_path, "wb") as out:

        def flush():
            nonlocal written
            if not buf_words:
                return
            data = records.serialize_table(
                np.array(buf_words, dtype=np.uint64).reshape(-1, W),
                np.array(buf_counts, dtype=np.uint32),
            )
            out.write(data)
            written += len(buf_words)
            buf_words.clear()
            buf_counts.clear()

        cur_key = None
        cur_count = 0
        while heap:
            key, i, count = heapq.heappop(heap)
            if key == cur_key:
                cur_count += count
            else:
                if cur_key is not None:
                    buf_words.append(cur_key)
                    buf_counts.append(min(cur_count, 0xFFFFFFFF))
                    if len(buf_words) >= _READ_RECORDS:
                        flush()
                cur_key, cur_count = key, count
            nxt = readers[i].pop()
            if nxt is not None:
                heapq.heappush(heap, (nxt[0], i, nxt[1]))
        if cur_key is not None:
            buf_words.append(cur_key)
            buf_counts.append(min(cur_count, 0xFFFFFFFF))
        flush()
    return written


class MergeScheduler:
    """Background hierarchical merge over spill runs
    (KMerFileMergeHandler analog, same knobs)."""

    def __init__(
        self,
        temp_dir: str,
        k: int,
        fan_in: int = 2,
        threads: int = 2,
        seq_start: int = 0,
    ):
        """``seq_start`` offsets intermediate-merge filenames — a resumed
        run (checkpoint.spill_runs) must never overwrite run files it is
        about to re-register."""
        self.temp_dir = temp_dir
        self.k = k
        self.fan_in = max(fan_in, 2)
        self.pool = ThreadPoolExecutor(max_workers=max(threads, 1))
        self._lock = threading.Lock()
        self._runs: list[str] = []
        self._errors: list[BaseException] = []
        self._pending = 0
        self._done = threading.Condition(self._lock)
        self._seq = seq_start
        os.makedirs(temp_dir, exist_ok=True)

    def add_run(self, path: str):
        """Register a new sorted run (AddFile, KMerFileMergeHandler.cpp:102-106)."""
        with self._lock:
            self._runs.append(path)
            self._maybe_merge_locked()

    def _maybe_merge_locked(self):
        # Merge eagerly while enough runs are queued; keep the last merge
        # for finish() so the final output path is controlled.
        if self._errors:
            return  # fail fast at finish(); don't retry a failing batch
        while len(self._runs) >= 2 * self.fan_in:
            batch, self._runs = self._runs[: self.fan_in], self._runs[self.fan_in :]
            self._seq += 1
            out = os.path.join(self.temp_dir, f"merge_{self._seq:06d}.run")
            self._pending += 1
            self.pool.submit(self._merge_job, batch, out)

    def _merge_job(self, batch, out):
        try:
            merge_runs(batch, out, self.k)
            for p in batch:
                try:
                    os.remove(p)
                except OSError:
                    pass
            with self._lock:
                self._runs.append(out)
                self._pending -= 1
                self._maybe_merge_locked()
                self._done.notify_all()
        except BaseException as e:
            # Never silently drop records: put the un-merged batch back in
            # the queue and surface the error at finish().
            with self._lock:
                self._runs.extend(batch)
                self._errors.append(e)
                self._pending -= 1
                self._done.notify_all()

    def snapshot_runs(self) -> list[str]:
        """Quiescent view of the outstanding run files for checkpointing:
        waits for in-flight merges (they delete their inputs), then
        returns the registered run paths — stable until the next
        add_run(), since merges are only triggered from there."""
        with self._lock:
            while self._pending:
                self._done.wait()
            if self._errors:
                raise RuntimeError(
                    f"{len(self._errors)} background merge(s) failed; first: "
                    f"{self._errors[0]!r}"
                ) from self._errors[0]
            return list(self._runs)

    def finish(self, out_path: str) -> int:
        """Wait for background merges, then merge all remaining runs into
        ``out_path`` (the final merge, KMerFileMergeHandler.cpp:93-99)."""
        with self._lock:
            while self._pending:
                self._done.wait()
            if self._errors:
                raise RuntimeError(
                    f"{len(self._errors)} background merge(s) failed; first: "
                    f"{self._errors[0]!r}"
                ) from self._errors[0]
            runs = list(self._runs)
            self._runs = []
        self.pool.shutdown(wait=True)
        n = merge_runs(runs, out_path, self.k)
        for p in runs:
            try:
                os.remove(p)
            except OSError:
                pass
        return n
