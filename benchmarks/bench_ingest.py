"""Host ingest throughput: sequential vs parallel parser pool (CPU-only).

Measures reads/s and MB/s through DirectoryInput (1 thread), the native
C++ reader, and ParallelIngest at several thread counts, over a synthetic
NVMe-like FASTQ directory.  This is the host-side half of the round-4
"ingest must feed a 150M+ k-mers/s chip" item (VERDICT r3 #5): at k=31,
L=100 the chip consumes reads at throughput/(L-k+1) ≈ 2.2M reads/s, so
the parser pool must at least match that.

Run: python benchmarks/bench_ingest.py [n_files] [reads_per_file]
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np


def make_dir(root, n_files, reads_per_file, L=100, seed=0):
    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    os.makedirs(root, exist_ok=True)
    qual = b"I" * L
    for f in range(n_files):
        rows = rng.integers(0, 4, size=(reads_per_file, L))
        with open(os.path.join(root, f"r{f:03d}.fastq"), "wb") as fh:
            for i, row in enumerate(rows):
                fh.write(b"@r%d\n" % i)
                fh.write(base[row].tobytes())
                fh.write(b"\n+\n")
                fh.write(qual)
                fh.write(b"\n")


def drain(src, chunk_reads=65536):
    reads = 0
    t0 = time.perf_counter()
    while True:
        c = src.read_chunk(chunk_reads)
        if c is None:
            break
        reads += c.n_reads
    dt = time.perf_counter() - t0
    src.close()
    return reads, dt


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from kmer_counter.io import native
    from kmer_counter.io.fastq import DirectoryInput, ParallelIngest

    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    reads_per_file = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    L = 100
    root = tempfile.mkdtemp(prefix="kmer_ingest_bench_")
    try:
        make_dir(root, n_files, reads_per_file, L)
        total_bytes = sum(
            os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)
        )
        print(
            f"{n_files} files x {reads_per_file} reads (L={L}), "
            f"{total_bytes / 1e6:.0f} MB, native={native.available()}",
            flush=True,
        )

        def report(name, reads, dt):
            print(
                f"  {name:28s} {reads / dt / 1e6:6.2f}M reads/s  "
                f"{total_bytes / dt / 1e6:7.0f} MB/s  ({dt:.2f}s)",
                flush=True,
            )

        for name, mk in [
            ("DirectoryInput python", lambda: DirectoryInput(root, use_native=False)),
            ("DirectoryInput native", lambda: DirectoryInput(root)),
            ("ParallelIngest t=2", lambda: ParallelIngest(root, threads=2)),
            ("ParallelIngest t=4", lambda: ParallelIngest(root, threads=4)),
            ("ParallelIngest t=8", lambda: ParallelIngest(root, threads=8)),
        ]:
            best = (0, float("inf"))
            for _ in range(2):
                reads, dt = drain(mk())
                assert reads == n_files * reads_per_file, (name, reads)
                if dt < best[1]:
                    best = (reads, dt)
            report(name, *best)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
