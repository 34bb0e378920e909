"""Orchestrator: chunked count loop over a FASTQ directory.

The device analog of KMerCounter (KMerCounter.cpp:108-191).  Where the
reference busy-waits on a pool of 8 CUDA streams and spawns a host thread
per chunk (KMerCounter.cpp:117-147), this engine exploits JAX's async
dispatch: a single host thread enqueues ``extract_chunk`` + ``append`` steps
that the device executes while the ingest prefetch thread parses the next
chunks — the same overlap with no stream bookkeeping.

Chunk sizing follows GetChunkSize's role (KMerCounter.cpp:193-212): the
``gpuMemoryLimit`` budget bounds the device working set — the accumulation
table gets half, and the per-chunk sort region (whose worst case is
``reads × (L-k+1)`` slots, the calculateOutputSize analog,
GPUHandler.cu:235-245) sizes the read count.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from kmer_counter import records
from kmer_counter.config import Options
from kmer_counter.io.dump import dump_table, load_table
from kmer_counter.io.fastq import DirectoryInput, ParallelIngest
from kmer_counter.ops import extract_chunk
from kmer_counter.ops import table as table_ops


def jnp_int32(x: int):
    import jax.numpy as jnp

    return jnp.int32(x)

_SENTINEL = object()


def _start_monitor(opts: Options, stats: RunStats, gauge_extra=None):
    """SizeMonitor under verbose>=2 (the reference's 1 Hz hashtable-size
    monitor thread, KMerCounter.cpp:92-96); a no-op context otherwise."""
    import contextlib

    if opts.verbose < 2:
        return contextlib.nullcontext()
    from kmer_counter.metrics import SizeMonitor

    def gauge():
        extra = f" {gauge_extra()}" if gauge_extra else ""
        return (
            f"reads={stats.reads} chunks={stats.chunks} "
            f"consolidations={stats.consolidations} "
            f"spills={stats.spilled_runs}{extra}"
        )

    return SizeMonitor(gauge)


def _finish_metrics(opts: Options, stats: RunStats, metrics) -> None:
    stats.metrics = metrics.snapshot()
    if opts.verbose:
        print(f"[metrics] {metrics.report()}")


def _make_source(opts: Options, shard=None):
    """Ingest source per config: the order-preserving multi-threaded
    parser pool when ingestThreads > 1 (io.fastq.ParallelIngest), else the
    sequential DirectoryInput — both produce the identical deterministic
    chunk stream."""
    if opts.ingest_threads > 1:
        return ParallelIngest(
            opts.input_dir, threads=opts.ingest_threads, shard=shard
        )
    return DirectoryInput(opts.input_dir, shard=shard)


def _file_key(path: str) -> str:
    """Checkpoint-manifest key for a source file (stable across absolute/
    relative invocation differences)."""
    import os

    return os.path.basename(path) if path else ""


@dataclass
class RunStats:
    """End-of-run summary (the observability the reference lacks, §5)."""

    reads: int = 0
    bases: int = 0
    chunks: int = 0
    consolidations: int = 0
    distinct_kmers: int = 0
    total_kmers: int = 0
    spilled_runs: int = 0
    ingest_seconds: float = 0.0
    wall_seconds: float = 0.0
    per_file: dict = field(default_factory=dict)
    # Metrics.snapshot() of the run: stage timers (host dispatch/drain
    # time) + counters — the structured observability SURVEY.md §5 calls
    # for (the reference has printf spam and a 1 Hz size monitor only).
    metrics: dict = field(default_factory=dict)

    @property
    def kmers_per_second(self) -> float:
        return self.total_kmers / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def reads_per_second(self) -> float:
        return self.reads / self.wall_seconds if self.wall_seconds else 0.0


def plan_chunks(
    opts: Options, line_length: int
) -> tuple[int, int]:
    """(reads_per_chunk, table_slots) under the device memory budget.

    Budget model: a table slot is (NL+1) uint32s; consolidation sorts the
    whole table with NL+2 operands and roughly doubles that working set, so
    the table gets budget/2 / (slot_bytes * 3).  The chunk worst case is
    reads*(L-k+1) slots and must fit 4x inside the table so appends
    amortize between consolidations.
    """
    k = opts.kmer_length
    if line_length < k:
        raise ValueError(
            f"line length {line_length} < k={k}: no k-mers can be extracted"
        )
    NL = records.active_lanes(k)  # device slots carry active lanes only
    slot_bytes = (NL + 1) * 4
    table_slots = opts.table_slots or max(
        opts.memory_limit_bytes // 2 // (slot_bytes * 3), 1 << 14
    )
    P = line_length - k + 1
    reads_per_chunk = opts.reads_per_chunk or max(table_slots // 4 // P, 16)
    # Re-check: chunk must fit the free half of the table even right after
    # a worst-case consolidation.
    if reads_per_chunk * P > table_slots // 2:
        table_slots = 2 * reads_per_chunk * P
    return reads_per_chunk, table_slots


# What ``tableImpl=auto`` runs, on every platform.  Both tables count the
# chip_smoke.py main size byte-exactly on one H100; PERF.md gives their
# wall times there.
AUTO_TABLE_IMPL = "one"


def use_two_level(table_impl: str) -> bool:
    """True when ``tableImpl`` selects the two-level table (ops.table2)."""
    return (AUTO_TABLE_IMPL if table_impl == "auto" else table_impl) == "two"


class CountEngine:
    """Single-process count engine (multi-host sharding in parallel/)."""

    def __init__(self, opts: Options, device=None):
        if opts.input_dir is None:
            raise ValueError("inputFileLocation is required")
        if opts.output_file is None:
            raise ValueError("outputFile is required")
        self.opts = opts
        self.device = device or jax.devices()[0]
        self._scheduler = None  # lazy spill-merge scheduler (io.spill)

    def _ingest_worker(
        self,
        source,
        reads_per_chunk,
        out_q,
        stats,
        skip_reads=0,
        expected_files=None,
    ):
        """Prefetch thread: parse chunks ahead of the device (the analog of
        the reference's reader-ahead main loop, KMerCounter.cpp:123-143).

        ``skip_reads`` reads are consumed and discarded first (checkpoint
        resume; ingest order is deterministic).  ``expected_files`` is the
        checkpoint's per-file absorbed-read manifest: per-file ingest fault
        tolerance can silently change the read sequence between runs (a
        file's readability changed), so the skip verifies it consumed
        exactly the recorded per-file counts and fails loudly otherwise
        (an Exception item on the queue, re-raised by the consumer)."""
        try:
            skipped: dict[str, int] = {}
            while skip_reads > 0:
                t0 = time.perf_counter()
                chunk = source.read_chunk(min(reads_per_chunk, skip_reads))
                stats.ingest_seconds += time.perf_counter() - t0
                if chunk is None:
                    break
                skip_reads -= chunk.n_reads
                name = _file_key(chunk.path)
                skipped[name] = skipped.get(name, 0) + chunk.n_reads
            if expected_files is not None and skipped != expected_files:
                out_q.put(
                    RuntimeError(
                        "checkpoint resume drift: the ingest skip consumed "
                        f"{skipped} but the checkpoint absorbed "
                        f"{expected_files} — the input directory's readable "
                        "file set changed since the snapshot; delete the "
                        "checkpoint to recount from scratch"
                    )
                )
                return
            while True:
                t0 = time.perf_counter()
                chunk = source.read_chunk(reads_per_chunk)
                stats.ingest_seconds += time.perf_counter() - t0
                if chunk is None:
                    break
                out_q.put(chunk)
        finally:
            out_q.put(_SENTINEL)

    def run(self) -> RunStats:
        if use_two_level(self.opts.table_impl):
            return self._run_two_level()
        return self._run_one_level()

    def _run_two_level(self) -> RunStats:
        """Chunk loop over the two-level table (ops.table2): keys-only raw
        appends, consolidate2 merges.  The prefix region is pre-grown so a
        consolidation can never truncate (lost is asserted 0)."""
        from kmer_counter.metrics import Metrics
        from kmer_counter.ops import table2 as t2
        from kmer_counter.ops.pipeline import count_step_two_level

        opts = self.opts
        k = opts.kmer_length
        stats = RunStats()
        metrics = Metrics()
        t_start = time.perf_counter()

        source = _make_source(opts)
        usable = [L for L in source.probe_line_lengths() if L >= k]
        if not usable:
            dump_table(
                opts.output_file,
                np.zeros((0, records.active_lanes(k)), np.uint32),
                np.zeros(0, np.uint32),
            )
            stats.wall_seconds = time.perf_counter() - t_start
            return stats
        line_length = max(usable)
        reads_per_chunk, table_slots = plan_chunks(opts, line_length)
        NL = records.active_lanes(k)

        # 1:7 prefix:raw split — more chunks per consolidation amortize the
        # merge sort over the prefix.  The prefix pre-grows on demand when
        # cardinality outruns it.
        cp = max(table_slots // 8, 1)
        cr = max(table_slots - cp, reads_per_chunk * (line_length - k + 1))
        if opts.verbose:
            print(
                f"[engine] two-level k={k} canonical={opts.canonical} "
                f"L={line_length} reads/chunk={reads_per_chunk} "
                f"prefix={cp} raw={cr} device={self.device}"
            )
        live_bound = 0  # prefix rows in use (exact after consolidation)
        raw_bound = 0  # raw slots in use (host-mirrored, exact)
        skip_reads = 0
        expected_files = None
        resumed = None
        if opts.checkpoint_dir:
            from kmer_counter import checkpoint as ckpt

            resumed = ckpt.load(opts.checkpoint_dir, opts)
        if resumed is not None:
            U = len(resumed.counts)
            cp = max(cp, U)
            pl = np.zeros((NL, cp), np.uint32)
            pc = np.zeros((cp,), np.uint32)
            pl[:, :U] = records.strip_lanes_to_active(resumed.lanes, k).T
            pc[:U] = resumed.counts
            table = jax.device_put(
                t2.TwoLevelTable(
                    pl,
                    pc,
                    np.zeros((NL, cr), np.uint32),
                    np.int32(0),
                    np.uint32(resumed.allt),
                ),
                self.device,
            )
            live_bound = U
            skip_reads = resumed.reads_absorbed
            expected_files = resumed.files
            stats.reads = skip_reads
            stats.per_file = dict(resumed.files or {})
            if resumed.spill_runs:
                self._resume_spill(resumed.spill_runs, stats)
            if opts.verbose:
                print(
                    f"[engine] resumed checkpoint: {U} records, "
                    f"{skip_reads} reads absorbed, "
                    f"{len(resumed.spill_runs)} spill runs"
                )
        else:
            table = jax.device_put(t2.make_table2(cp, cr, NL), self.device)

        chunk_q: "queue.Queue" = queue.Queue(maxsize=max(opts.prefetch_chunks, 1))
        ingest = threading.Thread(
            target=self._ingest_worker,
            args=(source, reads_per_chunk, chunk_q, stats, skip_reads, expected_files),
            daemon=True,
        )
        ingest.start()

        cp0 = cp

        def consolidate(table, cp, cr):
            # Pre-grow: live + raw is a hard upper bound on the distinct
            # keys a consolidation can produce, so growing to it first
            # makes truncation impossible.
            nonlocal live_bound
            if live_bound + raw_bound > cp:
                # Geometric growth (not exact-fit): every new prefix shape
                # recompiles the consolidation, so a cardinality-growing
                # run must see O(log) shapes, not one per consolidation.
                new_cp = max(live_bound + raw_bound, 2 * cp)
                if opts.verbose:
                    print(f"[engine] growing prefix to {new_cp} slots")
                table = t2.grow2(table, new_cp, cr)
                cp = new_cp
            with metrics.timer("consolidate"):
                table, live, lost = t2.consolidate2(table)
                live_bound = int(jax.device_get(live))
            lost_n = int(jax.device_get(lost))
            if lost_n:
                raise RuntimeError(
                    f"consolidation truncated {lost_n} live records: "
                    "prefix pre-grow invariant violated"
                )
            stats.consolidations += 1
            if (
                opts.checkpoint_every
                and opts.checkpoint_dir
                and stats.consolidations % opts.checkpoint_every == 0
            ):
                # The consolidated prefix contains every chunk enqueued so
                # far (stats.reads), making the snapshot exact.
                # consolidate2 can leave ≤2 live rows per key; fold them on
                # host so the snapshot is a plain sorted table.
                # With disk spill active, the snapshot additionally records
                # the quiescent spill-run manifest so resume re-registers
                # the runs (the post-spill table alone is partial).
                from kmer_counter import checkpoint as ckpt

                s_lanes = np.asarray(
                    jax.device_get(table.prefix_lanes[:, :live_bound])
                ).T
                s_counts = np.asarray(
                    jax.device_get(table.prefix_counts[:live_bound])
                )
                keep = s_counts > 0
                s_lanes, s_counts = s_lanes[keep], s_counts[keep]
                if len(s_counts):
                    head = np.concatenate(
                        [[True], (s_lanes[1:] != s_lanes[:-1]).any(axis=1)]
                    )
                    s_counts = np.add.reduceat(s_counts, np.flatnonzero(head))
                    s_lanes = s_lanes[head]
                ckpt.save(
                    opts.checkpoint_dir,
                    opts,
                    s_lanes,
                    s_counts,
                    stats.reads,
                    files=dict(stats.per_file),
                    allt=int(jax.device_get(table.allt)),
                    spill_runs=(
                        self._scheduler.snapshot_runs()
                        if self._scheduler is not None
                        else None
                    ),
                )
            if opts.temp_dir and (cp + cr) > self._max_table_slots_two(NL):
                # Cardinality outgrew the HBM budget: the table is fully
                # consolidated now — spill it as a sorted run, restart at
                # the planned prefix size (BASELINE.json config 4).
                table = self._spill_two(table, k, stats, cp0, cr)
                live_bound = 0
                cp = cp0
            return table, cp, cr

        cur_L = line_length
        cur_slots = reads_per_chunk * (cur_L - k + 1)
        with _start_monitor(
            opts, stats, lambda: f"raw={raw_bound}/{cr} live={live_bound}/{cp}"
        ):
            while True:
                item = chunk_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                name = _file_key(item.path)
                if item.line_length < k:
                    stats.reads += item.n_reads
                    stats.bases += item.n_reads * item.line_length
                    stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads
                    continue
                if item.line_length != cur_L:
                    cur_L = item.line_length
                    cur_slots = reads_per_chunk * (cur_L - k + 1)
                reads = item.reads
                if reads.shape[0] < reads_per_chunk:
                    pad = np.zeros(
                        (reads_per_chunk - reads.shape[0], reads.shape[1]),
                        dtype=np.uint8,
                    )
                    reads = np.vstack([reads, pad])
                if raw_bound + cur_slots > cr:
                    table, cp, cr = consolidate(table, cp, cr)
                    raw_bound = 0
                with metrics.timer("dispatch"):
                    # Host enqueue time (the fused extract+append runs
                    # async on device; device time shows up in the
                    # consolidate / finalize drains).
                    dev_reads = jax.device_put(reads, self.device)
                    table = count_step_two_level(
                        table, dev_reads, k, opts.canonical
                    )
                raw_bound += cur_slots
                stats.chunks += 1
                stats.reads += item.n_reads
                stats.bases += item.n_reads * item.line_length
                stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads

        ingest.join()
        if live_bound + raw_bound > cp:
            # the same pre-grow guarantee for the final merge
            table = t2.grow2(table, live_bound + raw_bound, cr)
        with metrics.timer("finalize"):
            lanes_np, counts_np = t2.finalize_host(table, k)
        stats.consolidations += 1
        if self._scheduler is not None:
            from kmer_counter.io import spill as spill_io
            import os

            stats.spilled_runs += 1
            self._scheduler.add_run(
                spill_io.write_run(
                    os.path.join(opts.temp_dir, "final_table.run"),
                    lanes_np,
                    counts_np,
                )
            )
            written = self._scheduler.finish(opts.output_file)
            self._scheduler = None
            stats.distinct_kmers = written
            _, counts_all = load_table(opts.output_file, k)
            stats.total_kmers = int(counts_all.sum())
        else:
            stats.distinct_kmers = len(counts_np)
            stats.total_kmers = int(counts_np.sum())
            dump_table(opts.output_file, lanes_np, counts_np)
        stats.wall_seconds = time.perf_counter() - t_start
        metrics.count("reads", stats.reads)
        metrics.count("chunks", stats.chunks)
        metrics.count("consolidations", stats.consolidations)
        metrics.count("distinct_kmers", stats.distinct_kmers)
        _finish_metrics(opts, stats, metrics)
        if opts.verbose:
            print(
                f"[engine] reads={stats.reads} bases={stats.bases} "
                f"distinct={stats.distinct_kmers} total={stats.total_kmers} "
                f"chunks={stats.chunks} consolidations={stats.consolidations} "
                f"wall={stats.wall_seconds:.2f}s "
                f"({stats.kmers_per_second/1e6:.2f}M kmers/s)"
            )
        return stats

    def _max_table_slots_two(self, NL: int) -> int:
        if self.opts.table_slots:
            return 2 * self.opts.table_slots
        return 4 * max(
            self.opts.memory_limit_bytes // 2 // ((NL + 1) * 4 * 3), 1 << 14
        )

    def _spill_two(self, table, k: int, stats, new_cp: int, new_cr: int):
        """Finalize the current two-level table to a sorted run on disk and
        restart empty at the planned size (cardinality outgrew HBM,
        BASELINE.json config 4)."""
        import os

        from kmer_counter.io import spill as spill_io
        from kmer_counter.ops import table2 as t2

        opts = self.opts
        if self._scheduler is None:
            self._scheduler = spill_io.MergeScheduler(
                opts.temp_dir,
                k,
                fan_in=opts.no_of_mergers_at_once,
                threads=opts.no_of_merge_threads,
            )
        lanes_np, counts_np = t2.finalize_host(table, k)
        stats.spilled_runs += 1
        path = os.path.join(opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run")
        self._scheduler.add_run(spill_io.write_run(path, lanes_np, counts_np))
        if opts.verbose:
            print(f"[engine] spilled {len(counts_np)} records -> {path}")
        NL = table.prefix_lanes.shape[0]
        return jax.device_put(t2.make_table2(new_cp, new_cr, NL), self.device)

    def _run_one_level(self) -> RunStats:
        from kmer_counter.metrics import Metrics

        opts = self.opts
        k = opts.kmer_length
        stats = RunStats()
        metrics = Metrics()
        t_start = time.perf_counter()

        source = _make_source(opts)
        all_lengths = source.probe_line_lengths()
        usable = [L for L in all_lengths if L >= k]
        if not usable:
            # No file has reads long enough for a single k-mer.
            dump_table(opts.output_file, np.zeros((0, records.active_lanes(k)), np.uint32), np.zeros(0, np.uint32))
            stats.wall_seconds = time.perf_counter() - t_start
            return stats
        line_length = max(usable)
        reads_per_chunk, table_slots = plan_chunks(opts, line_length)
        NL = records.active_lanes(k)
        if opts.verbose:
            print(
                f"[engine] k={k} canonical={opts.canonical} L={line_length} "
                f"reads/chunk={reads_per_chunk} table_slots={table_slots} "
                f"device={self.device}"
            )

        host_bound = 0  # worst-case table offset (see ops.table docstring)
        skip_reads = 0
        expected_files = None
        resumed = None
        if opts.checkpoint_dir:
            from kmer_counter import checkpoint as ckpt

            resumed = ckpt.load(opts.checkpoint_dir, opts)
        if resumed is not None:
            ck_lanes, ck_counts = resumed.lanes, resumed.counts
            skip_reads = resumed.reads_absorbed
            expected_files = resumed.files
            stats.per_file = dict(resumed.files or {})
            U = len(ck_counts)
            while U + reads_per_chunk * (line_length - k + 1) > table_slots:
                table_slots *= 2
            init_lanes = np.zeros((NL, table_slots), np.uint32)
            init_counts = np.zeros((table_slots,), np.uint32)
            # host tables are record-major, ABI width; device carries active lanes
            init_lanes[:, :U] = records.strip_lanes_to_active(ck_lanes, k).T
            init_counts[:U] = ck_counts
            table = jax.device_put(
                table_ops.CountTable(init_lanes, init_counts, np.int32(U)),
                self.device,
            )
            host_bound = U
            stats.reads = skip_reads
            if resumed.spill_runs:
                self._resume_spill(resumed.spill_runs, stats)
            if opts.verbose:
                print(
                    f"[engine] resumed checkpoint: {U} records, "
                    f"{skip_reads} reads absorbed, "
                    f"{len(resumed.spill_runs)} spill runs"
                )
        else:
            table = jax.device_put(
                table_ops.make_table(table_slots, NL), self.device
            )
        chunk_q: "queue.Queue" = queue.Queue(maxsize=max(opts.prefetch_chunks, 1))
        ingest = threading.Thread(
            target=self._ingest_worker,
            args=(source, reads_per_chunk, chunk_q, stats, skip_reads, expected_files),
            daemon=True,
        )
        ingest.start()

        cur_L = line_length
        cur_slots = reads_per_chunk * (cur_L - k + 1)
        with _start_monitor(
            opts, stats, lambda: f"bound={host_bound}/{table_slots}"
        ):
            while True:
                item = chunk_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                name = _file_key(item.path)
                if item.line_length < k:
                    # No k-mers can come from these reads; skip the chunk
                    # (the golden model skips short reads too).
                    stats.reads += item.n_reads
                    stats.bases += item.n_reads * item.line_length
                    stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads
                    continue
                if item.line_length != cur_L:
                    # New file with a different read length: new static shapes.
                    cur_L = item.line_length
                    cur_slots = reads_per_chunk * (cur_L - k + 1)
                reads = item.reads
                if reads.shape[0] < reads_per_chunk:
                    # Pad the final partial chunk to the static shape; zero rows
                    # are masked invalid by the encoder.
                    pad = np.zeros(
                        (reads_per_chunk - reads.shape[0], reads.shape[1]),
                        dtype=np.uint8,
                    )
                    reads = np.vstack([reads, pad])
                if host_bound + cur_slots > table_slots:
                    with metrics.timer("consolidate"):
                        table = table_ops.consolidate(table)
                        host_bound = int(jax.device_get(table.offset))
                    stats.consolidations += 1
                    if (
                        opts.checkpoint_every
                        and opts.checkpoint_dir
                        and stats.consolidations % opts.checkpoint_every == 0
                    ):
                        # The consolidated table contains every chunk enqueued
                        # so far (stats.reads), making the snapshot exact; any
                        # outstanding spill runs are recorded for resume.
                        from kmer_counter import checkpoint as ckpt

                        ckpt.save(
                            opts.checkpoint_dir,
                            opts,
                            np.asarray(jax.device_get(table.lanes[:, :host_bound])).T,
                            np.asarray(jax.device_get(table.counts[:host_bound])),
                            stats.reads,
                            files=dict(stats.per_file),
                            spill_runs=(
                                self._scheduler.snapshot_runs()
                                if self._scheduler is not None
                                else None
                            ),
                        )
                    if host_bound + cur_slots > table_slots:
                        if (
                            opts.temp_dir
                            and table_slots * 2 > self._max_table_slots(table)
                        ):
                            # Cardinality outgrew the HBM budget: spill the
                            # consolidated table as a sorted run and restart
                            # with an empty table (BASELINE.json config 4).
                            table, host_bound = self._spill(table, host_bound, stats)
                        else:
                            table = self._grow_for(table, host_bound + cur_slots)
                            table_slots = table.lanes.shape[1]
                with metrics.timer("dispatch"):
                    dev_reads = jax.device_put(reads, self.device)
                    lanes, counts = extract_chunk(dev_reads, k, opts.canonical)
                    table = table_ops.append(
                        table, lanes, counts, jnp_int32(cur_slots)
                    )
                host_bound += cur_slots
                stats.chunks += 1
                stats.reads += item.n_reads
                stats.bases += item.n_reads * item.line_length
                stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads

        ingest.join()
        with metrics.timer("finalize"):
            table = table_ops.consolidate(table)
        stats.consolidations += 1
        num_unique = int(jax.device_get(table.offset))
        lanes = np.asarray(jax.device_get(table.lanes[:, :num_unique])).T
        counts = np.asarray(jax.device_get(table.counts[:num_unique]))
        if self._scheduler is not None:
            # Final table joins the spill runs; the hierarchical host merge
            # produces the globally sorted output.
            from kmer_counter.io import spill as spill_io
            import os

            stats.spilled_runs += 1
            self._scheduler.add_run(
                spill_io.write_run(
                    os.path.join(opts.temp_dir, "final_table.run"), lanes, counts
                )
            )
            written = self._scheduler.finish(opts.output_file)
            self._scheduler = None
            stats.distinct_kmers = written
            _, counts_all = load_table(opts.output_file, k)
            stats.total_kmers = int(counts_all.sum())
        else:
            stats.distinct_kmers = num_unique
            stats.total_kmers = int(counts.sum())
            dump_table(opts.output_file, lanes, counts)
        stats.wall_seconds = time.perf_counter() - t_start
        metrics.count("reads", stats.reads)
        metrics.count("chunks", stats.chunks)
        metrics.count("consolidations", stats.consolidations)
        metrics.count("distinct_kmers", stats.distinct_kmers)
        _finish_metrics(opts, stats, metrics)
        if opts.verbose:
            print(
                f"[engine] reads={stats.reads} bases={stats.bases} "
                f"distinct={stats.distinct_kmers} total={stats.total_kmers} "
                f"chunks={stats.chunks} consolidations={stats.consolidations} "
                f"wall={stats.wall_seconds:.2f}s "
                f"({stats.kmers_per_second/1e6:.2f}M kmers/s)"
            )
        return stats

    def _max_table_slots(self, table) -> int:
        """Largest table the HBM budget tolerates before spilling: 2x an
        explicit tableSlots cap, else 4x the budget-planned capacity (the
        plan leaves half the budget for sort temps)."""
        if self.opts.table_slots:
            return 2 * self.opts.table_slots
        NL = table.lanes.shape[0]
        return 4 * max(
            self.opts.memory_limit_bytes // 2 // ((NL + 1) * 4 * 3), 1 << 14
        )

    def _resume_spill(self, spill_runs: dict, stats):
        """Rebuild the merge scheduler from a checkpoint's spill-run
        manifest (resume ACROSS disk spill).  Filename sequences restart
        past every existing file in the temp dir, so re-registered runs
        (and orphans of the crashed run) are never overwritten."""
        import os
        import re

        from kmer_counter.io import spill as spill_io

        opts = self.opts
        if not opts.temp_dir:
            raise RuntimeError(
                "checkpoint lists spill runs but no tempFileLocation is set"
            )
        seqs = [0]
        if os.path.isdir(opts.temp_dir):
            for name in os.listdir(opts.temp_dir):
                m = re.match(r"(?:spill|merge)_(\d+)\.run$", name)
                if m:
                    seqs.append(int(m.group(1)))
        top = max(seqs)
        self._scheduler = spill_io.MergeScheduler(
            opts.temp_dir,
            opts.kmer_length,
            fan_in=opts.no_of_mergers_at_once,
            threads=opts.no_of_merge_threads,
            seq_start=top,
        )
        stats.spilled_runs = max(stats.spilled_runs, top)
        for path in spill_runs:
            self._scheduler.add_run(path)

    def _spill(self, table, num_unique: int, stats):
        """Dump the consolidated table as a sorted run; reset to empty."""
        import os

        from kmer_counter.io import spill as spill_io

        opts = self.opts
        if self._scheduler is None:
            self._scheduler = spill_io.MergeScheduler(
                opts.temp_dir,
                opts.kmer_length,
                fan_in=opts.no_of_mergers_at_once,
                threads=opts.no_of_merge_threads,
            )
        lanes = np.asarray(jax.device_get(table.lanes[:, :num_unique])).T
        counts = np.asarray(jax.device_get(table.counts[:num_unique]))
        stats.spilled_runs += 1
        path = os.path.join(opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run")
        self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
        if opts.verbose:
            print(f"[engine] spilled {num_unique} records -> {path}")
        NL, C = table.lanes.shape
        fresh = jax.device_put(table_ops.make_table(C, NL), self.device)
        return fresh, 0

    def _grow_for(self, table, needed_slots: int):
        """Double capacity until the next chunk fits (cardinality outgrew
        the initial budget — the reference would spill to disk here)."""
        cap = table.lanes.shape[1]
        while cap < needed_slots:
            cap *= 2
        if self.opts.verbose:
            print(f"[engine] growing table to {cap} slots")
        return table_ops.grow(table, cap)


class MeshCountEngine:
    """Multi-device count engine: the same chunk loop driving a
    ShardedCounter over a ``data`` mesh (parallel.pipeline), with the final
    all_to_all prefix merge replacing both host aggregation and disk merge.

    On a multi-host slice each process runs this engine over the global
    mesh; ingest shards by file round-robin on ``jax.process_index()``.
    """

    def __init__(self, opts: Options, mesh=None):
        if opts.input_dir is None:
            raise ValueError("inputFileLocation is required")
        if opts.output_file is None:
            raise ValueError("outputFile is required")
        from kmer_counter.parallel.mesh import make_mesh

        self.opts = opts
        self.mesh = mesh if mesh is not None else make_mesh(
            opts.mesh_shape[0] if opts.mesh_shape else None
        )
        self._scheduler = None  # lazy spill-merge scheduler (io.spill)
        self._pos_runs = None  # multi-process: spilled runs by mesh position

    def _max_slots_per_device(self, NL: int, D: int) -> int:
        """Per-device HBM slot budget before spilling (the mesh share of
        CountEngine._max_table_slots_two's global budget)."""
        if self.opts.table_slots:
            return max(2 * self.opts.table_slots // D, 1)
        total = 4 * max(
            self.opts.memory_limit_bytes // 2 // ((NL + 1) * 4 * 3), 1 << 14
        )
        return max(total // D, 1)

    def _spill_counter(self, counter, stats):
        """Export the counter's consolidated state as sorted runs and empty
        it (the mesh form of CountEngine._spill; reference analog:
        FileDump.cpp:51-58 + the disk merge tree).

        Single-process: every local device's partial table spills as a
        full-key-space run; the MergeScheduler's hierarchical merge
        produces the final output.

        Multi-process: records are first routed to their prefix-range
        owner chips (the same all_to_all collective finalize uses — every
        process reaches this point in lockstep, the trigger being
        host-mirrored state), then each process spills only its
        addressable positions' ranges as per-position runs.  The final
        assembly merges each position's runs host-side; the range
        partition is monotonic in mesh position, so the ``.part`` files
        still concatenate into the globally sorted table.  (This replaces
        the round-3 hard MemoryError; reference role:
        KMerFileMergeHandler.cpp:49-100.)"""
        import os

        from kmer_counter.io import spill as spill_io

        opts = self.opts
        if jax.process_count() > 1:
            if self._pos_runs is None:
                self._pos_runs = {}
            os.makedirs(opts.temp_dir, exist_ok=True)
            for pos, lanes, counts in counter.finalize_local():
                stats.spilled_runs += 1
                path = os.path.join(
                    opts.temp_dir,
                    f"spill_pos{pos:05d}_{stats.spilled_runs:06d}.run",
                )
                self._pos_runs.setdefault(pos, []).append(
                    spill_io.write_run(path, lanes, counts)
                )
                if opts.verbose:
                    print(
                        f"[engine] spilled range {pos}: {len(counts)} "
                        f"records -> {path}"
                    )
            counter.reset()
            return
        if self._scheduler is None:
            self._scheduler = spill_io.MergeScheduler(
                opts.temp_dir,
                opts.kmer_length,
                fan_in=opts.no_of_mergers_at_once,
                threads=opts.no_of_merge_threads,
            )
        for lanes, counts in counter.local_tables():
            stats.spilled_runs += 1
            path = os.path.join(
                opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run"
            )
            self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
            if opts.verbose:
                print(f"[engine] spilled {len(counts)} records -> {path}")
        counter.reset()

    def _save_checkpoint(self, counter, stats) -> None:
        """Snapshot the mesh run (checkpoint.mesh_save): this process's
        consolidated position tables + reads absorbed + per-file manifest
        + frozen splitters + outstanding spill runs.  Called at a
        consolidation boundary, in lockstep (host-mirrored trigger)."""
        from kmer_counter import checkpoint as ckpt

        items = counter.export_positions()  # consolidates if needed
        splitters = None
        if getattr(counter, "_splitters", None) is not None:
            splitters = np.asarray(jax.device_get(counter._splitters))
        ckpt.mesh_save(
            self.opts.checkpoint_dir,
            self.opts,
            stats.consolidations,
            items,
            stats.reads,
            stats.per_file,
            mesh_size=self.mesh.devices.size,
            splitters=splitters,
            pos_runs=self._pos_runs,
            scheduler_runs=(
                self._scheduler.snapshot_runs()
                if self._scheduler is not None
                else None
            ),
        )

    def _load_checkpoint(self, counter, stats):
        """Resume from the newest complete mesh checkpoint, agreed in
        lockstep across processes (all resume the same epoch or none).
        Returns the MeshSnapshot or None."""
        import os
        import sys

        opts = self.opts
        if not opts.checkpoint_dir:
            return None
        from kmer_counter import checkpoint as ckpt

        my_positions = [
            pos
            for pos, d in enumerate(self.mesh.devices.flat)
            if d.process_index == jax.process_index()
        ]
        resumed = ckpt.mesh_load(
            opts.checkpoint_dir, opts, self.mesh.devices.size, my_positions
        )
        epoch = resumed.epoch if resumed is not None else -1
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            all_epochs = multihost_utils.process_allgather(
                np.array([epoch], np.int64)
            )
            if int(np.min(all_epochs)) != int(np.max(all_epochs)):
                # Shouldn't happen on a shared checkpoint dir; recount
                # rather than resume inconsistently.
                print(
                    "[checkpoint] processes disagree on the resume epoch — "
                    "recounting from scratch",
                    file=sys.stderr,
                )
                return None
            if epoch < 0:
                return None
        elif resumed is None:
            return None
        counter.import_positions(resumed.items, resumed.splitters)
        stats.reads = resumed.reads_absorbed
        stats.per_file = dict(resumed.files or {})
        stats.consolidations = resumed.epoch
        if resumed.pos_runs:
            import re

            self._pos_runs = {
                int(p): list(v) for p, v in resumed.pos_runs.items()
            }
            # Restart run-file sequence numbers past every existing file so
            # re-registered runs (and crashed-run orphans) are never
            # overwritten.
            seqs = [0]
            if opts.temp_dir and os.path.isdir(opts.temp_dir):
                for name in os.listdir(opts.temp_dir):
                    m = re.search(r"_(\d+)\.run$", name)
                    if m:
                        seqs.append(int(m.group(1)))
            stats.spilled_runs = max(seqs)
        if resumed.scheduler_runs:
            CountEngine._resume_spill(self, resumed.scheduler_runs, stats)
        if opts.verbose:
            total = sum(len(c) for _, _, c, _ in resumed.items)
            print(
                f"[engine] resumed mesh checkpoint epoch {resumed.epoch}: "
                f"{total} records (this process), "
                f"{resumed.reads_absorbed} reads absorbed"
            )
        return resumed

    def run(self) -> RunStats:
        from kmer_counter.metrics import Metrics
        from kmer_counter.parallel.pipeline import (
            ShardedCounter,
            ShardedCounter2,
        )

        opts = self.opts
        k = opts.kmer_length
        stats = RunStats()
        metrics = Metrics()
        t_start = time.perf_counter()
        D = self.mesh.devices.size

        multi_process = jax.process_count() > 1
        shard = None
        if multi_process:
            shard = (jax.process_index(), jax.process_count())
        source = _make_source(opts, shard=shard)
        usable = [L for L in source.probe_line_lengths() if L >= k]
        if multi_process:
            # Every process must agree on the chunk shape (the step is a
            # collective): take the global max usable line length.
            from jax.experimental import multihost_utils

            local_max = max(usable) if usable else 0
            all_max = multihost_utils.process_allgather(
                np.array([local_max], np.int32)
            )
            global_max = int(np.max(all_max))
            usable = [global_max] if global_max >= k else []
        if not usable:
            dump_table(
                opts.output_file,
                np.zeros((0, records.active_lanes(k)), np.uint32),
                np.zeros(0, np.uint32),
            )
            stats.wall_seconds = time.perf_counter() - t_start
            return stats
        line_length = max(usable)
        reads_per_chunk, table_slots = plan_chunks(opts, line_length)
        # Round the global chunk up to a multiple of the mesh size.
        reads_per_device = max(reads_per_chunk // D, 1)
        if opts.verbose:
            print(
                f"[engine] mesh={D}dev k={k} canonical={opts.canonical} "
                f"L={line_length} reads/dev/chunk={reads_per_device} "
                f"table_slots/dev={table_slots // D + 1}"
            )

        # One counter at the (global) max line length; chunks from shorter
        # files are column-padded with zero bytes, which the encoder masks
        # invalid — semantically identical to per-length processing, and it
        # keeps the multi-host step a uniform collective.
        NL = records.active_lanes(k)
        per_dev_slots = max(
            table_slots // D, 4 * reads_per_device * (line_length - k + 1)
        )
        if use_two_level(opts.table_impl):
            cp = max(per_dev_slots // 4, 1)
            counter = ShardedCounter2(
                self.mesh,
                k,
                opts.canonical,
                prefix_slots=cp,
                raw_slots=max(per_dev_slots - cp, 1),
                reads_per_device=reads_per_device,
                line_length=line_length,
                merge_slack=opts.merge_slack,
            )
        else:
            counter = ShardedCounter(
                self.mesh,
                k,
                opts.canonical,
                table_slots=per_dev_slots,
                reads_per_device=reads_per_device,
                line_length=line_length,
                merge_slack=opts.merge_slack,
            )
        max_dev_slots = self._max_slots_per_device(NL, D)

        # Checkpoint resume (mesh form): load the newest COMPLETE epoch —
        # every process restores its own positions' tables + ingest skip,
        # and the decision is agreed in lockstep (_load_checkpoint).
        skip_reads = 0
        expected_files = None
        resumed = self._load_checkpoint(counter, stats)
        if resumed is not None:
            skip_reads = resumed.reads_absorbed
            expected_files = resumed.files or None

        # Each process supplies rows for its own devices only; the step
        # assembles the global array from per-process blocks.
        local_devices = sum(
            1
            for d in self.mesh.devices.flat
            if d.process_index == jax.process_index()
        )
        want_rows = reads_per_device * local_devices
        chunk_q: "queue.Queue" = queue.Queue(maxsize=max(opts.prefetch_chunks, 1))
        ingest = threading.Thread(
            target=CountEngine._ingest_worker,
            args=(self, source, want_rows, chunk_q, stats, skip_reads, expected_files),
            daemon=True,
        )
        ingest.start()

        def next_local_chunk():
            """(reads [want_rows, L], source item) or (None, None) when
            drained.  The item's read accounting happens AFTER the device
            step (account_chunk): a checkpoint taken at a consolidation
            boundary must count exactly the dispatched chunks, or resume
            would skip a chunk whose counts never entered the table."""
            while True:
                item = chunk_q.get()
                if item is _SENTINEL:
                    return None, None
                if isinstance(item, Exception):
                    raise item
                if item.line_length < k:
                    # No k-mers can come from these reads: absorbed
                    # without a device step — safe to count immediately.
                    name = _file_key(item.path)
                    stats.reads += item.n_reads
                    stats.bases += item.n_reads * item.line_length
                    stats.per_file[name] = (
                        stats.per_file.get(name, 0) + item.n_reads
                    )
                    continue
                reads = item.reads
                if reads.shape[1] < line_length:
                    reads = np.pad(
                        reads, ((0, 0), (0, line_length - reads.shape[1]))
                    )
                if reads.shape[0] < want_rows:
                    reads = np.pad(
                        reads, ((0, want_rows - reads.shape[0]), (0, 0))
                    )
                return reads, item

        def account_chunk(item):
            name = _file_key(item.path)
            stats.reads += item.n_reads
            stats.bases += item.n_reads * item.line_length
            stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads
            stats.chunks += 1

        def maybe_consolidate():
            # Explicit consolidation boundary (the counter would otherwise
            # consolidate inside step()): lets the engine spill under HBM
            # pressure and snapshot at exactly the consolidated points.
            # Every trigger is host-mirrored state, so on a multi-process
            # mesh all processes reach the same decision in lockstep.
            if not counter.pending_consolidation():
                return
            if opts.temp_dir and counter.occupied_bound() > max_dev_slots:
                # Pressure valve (BASELINE.json config 4 at mesh scale).
                self._spill_counter(counter, stats)
            else:
                counter.consolidate()
            stats.consolidations += 1
            if (
                opts.checkpoint_every
                and opts.checkpoint_dir
                and stats.consolidations % opts.checkpoint_every == 0
            ):
                with metrics.timer("checkpoint"):
                    self._save_checkpoint(counter, stats)

        with _start_monitor(
            opts,
            stats,
            lambda: f"occupied/dev={counter.occupied_bound()}",
        ):
            if multi_process:
                from jax.experimental import multihost_utils

                empty = np.zeros((want_rows, line_length), np.uint8)
                drained = False
                while True:
                    item = None
                    if drained:
                        reads = None
                    else:
                        reads, item = next_local_chunk()
                    drained = reads is None
                    # Lockstep: continue while any process still has data.
                    anyone = multihost_utils.process_allgather(
                        np.array([not drained], bool)
                    )
                    if not bool(np.any(anyone)):
                        break
                    maybe_consolidate()
                    with metrics.timer("dispatch"):
                        counter.step(reads if reads is not None else empty)
                    if item is not None:
                        account_chunk(item)
            else:
                while True:
                    reads, item = next_local_chunk()
                    if reads is None:
                        break
                    maybe_consolidate()
                    with metrics.timer("dispatch"):
                        counter.step(reads)
                    account_chunk(item)
        ingest.join()

        # The all-T side count (two-level tables, k % 16 == 0, forward):
        # the T^k key is the maximum possible key, so it always lands at
        # the very end of the globally sorted output.
        allt = counter.allt_total()
        allt_lanes = np.full((1, records.active_lanes(k)), 0xFFFFFFFF, np.uint32)
        # Counts are modular uint32 across the whole table (the record ABI's
        # count field width; sortcount's folds wrap by design), and the
        # per-device allt accumulators are uint32 too — so the side count is
        # reduced mod 2^32 like every other count, not clamped (ADVICE r3).
        allt_counts = np.asarray([allt & 0xFFFFFFFF], np.uint32)

        if self._scheduler is not None:
            # Spills happened: the final local tables join the runs and the
            # hierarchical host merge produces the sorted output.
            import os

            from kmer_counter.io import spill as spill_io

            for lanes, counts in counter.local_tables():
                stats.spilled_runs += 1
                path = os.path.join(
                    opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run"
                )
                self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
            with metrics.timer("finalize"):
                written = self._scheduler.finish(opts.output_file)
            self._scheduler = None
            if allt:
                written += dump_table(
                    opts.output_file, allt_lanes, allt_counts, append=True
                )
            stats.distinct_kmers = written
            _, counts_all = load_table(opts.output_file, k)
            stats.total_kmers = int(counts_all.sum())
            stats.wall_seconds = time.perf_counter() - t_start
            metrics.count("reads", stats.reads)
            metrics.count("chunks", stats.chunks)
            metrics.count("distinct_kmers", stats.distinct_kmers)
            _finish_metrics(opts, stats, metrics)
            return stats

        if multi_process:
            # Multi-host: every process dumps only its addressable key
            # ranges as part files; concatenating parts in name order is
            # the globally sorted table (range partition is monotonic).
            # When per-position spill runs exist (HBM pressure mid-run),
            # each range's part is the host-side merge of its runs with
            # the final routed table — still sorted, still range-local.
            import json
            import os as _os

            from kmer_counter.io import spill as spill_io

            written = 0
            with metrics.timer("finalize"):
                parts_out = counter.finalize_local()
            for pos, lanes, counts in parts_out:
                part = f"{opts.output_file}.part{pos:05d}"
                runs = (self._pos_runs or {}).get(pos)
                if runs:
                    final_run = _os.path.join(
                        opts.temp_dir, f"final_pos{pos:05d}.run"
                    )
                    spill_io.write_run(final_run, lanes, counts)
                    n = spill_io.merge_runs(runs + [final_run], part, k)
                    for p in runs + [final_run]:
                        try:
                            _os.remove(p)
                        except OSError:
                            pass
                else:
                    n = dump_table(part, lanes, counts)
                if allt and pos == D - 1:
                    # T^k (max key) belongs at the very end of the last range.
                    n += dump_table(part, allt_lanes, allt_counts, append=True)
                written += n
            manifest = f"{opts.output_file}.manifest.{jax.process_index()}.json"
            with open(manifest, "w") as fh:
                json.dump(
                    {
                        "process": jax.process_index(),
                        "processes": jax.process_count(),
                        "records": written,
                        "assembly": "cat output.part* (name order) -> sorted table",
                    },
                    fh,
                )
            stats.distinct_kmers = written
            stats.wall_seconds = time.perf_counter() - t_start
            metrics.count("reads", stats.reads)
            metrics.count("chunks", stats.chunks)
            metrics.count("distinct_kmers", stats.distinct_kmers)
            _finish_metrics(opts, stats, metrics)
            return stats

        with metrics.timer("finalize"):
            lanes, counts = counter.finalize()
        counts = np.asarray(counts, np.uint32)
        if allt:
            if lanes.shape[0] and np.array_equal(lanes[-1], allt_lanes[0]):
                raise RuntimeError(
                    "all-T key present in the key stream despite the side "
                    "counter: extract_chunk_keys contract violated"
                )
            lanes = np.concatenate([lanes, allt_lanes])
            counts = np.concatenate([counts, allt_counts])

        stats.distinct_kmers = len(counts)
        stats.total_kmers = int(counts.sum())
        dump_table(opts.output_file, lanes, counts)
        stats.wall_seconds = time.perf_counter() - t_start
        metrics.count("reads", stats.reads)
        metrics.count("chunks", stats.chunks)
        metrics.count("distinct_kmers", stats.distinct_kmers)
        _finish_metrics(opts, stats, metrics)
        if opts.verbose:
            print(
                f"[engine] reads={stats.reads} distinct={stats.distinct_kmers} "
                f"total={stats.total_kmers} wall={stats.wall_seconds:.2f}s "
                f"({stats.kmers_per_second/1e6:.2f}M kmers/s over {D} devices)"
            )
        return stats


def run_count(opts: Options) -> RunStats:
    """Dispatch to the mesh engine when more than one device is visible (or
    an explicit mesh shape is configured); single-device engine otherwise.

    With ``profile=true`` the whole run is wrapped in a jax.profiler trace
    written next to the output file (<output>.trace/).
    """
    from kmer_counter.metrics import device_trace

    trace_dir = (
        opts.output_file + ".trace" if (opts.profile and opts.output_file) else None
    )
    with device_trace(trace_dir):
        n_dev = len(jax.devices())
        if opts.mesh_shape is not None or n_dev > 1:
            return MeshCountEngine(opts).run()
        return CountEngine(opts).run()
