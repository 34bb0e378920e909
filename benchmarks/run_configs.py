"""BASELINE.json configs 1-5: correctness + throughput harness.

Generates a synthetic genome-derived FASTQ fixture per config, runs the
real engine end-to-end (ingest → device pipeline → merge → sorted dump),
verifies the output byte-exactly against the golden model, and prints one
JSON line per config.

Usage:
    python benchmarks/run_configs.py [--configs 1,2,3] [--scale N]

Runs on whatever devices are visible: a GPU, or a CPU (optionally with XLA_FLAGS=--xla_force_host_platform_device_count=8
to exercise config 5's mesh path on virtual devices).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def make_fixture(dirpath, rng, n_reads, L, n_files=1, genome_len=100_000, invalid=0.0):
    from kmer_counter.utils.seqgen import make_fastq_dir

    os.makedirs(dirpath, exist_ok=True)
    return make_fastq_dir(
        dirpath, rng, n_reads, L, n_files, genome_len, invalid_frac=invalid
    )


def golden_table(dirpath, k, canonical):
    from kmer_counter import golden

    counter = {}
    for name in sorted(os.listdir(dirpath)):
        lines = open(os.path.join(dirpath, name)).read().splitlines()
        seqs = [lines[i] for i in range(1, len(lines), 4)]
        for key, c in golden.count_reads(seqs, k, canonical).items():
            counter[key] = counter.get(key, 0) + c
    return golden.table_from_counter(counter)


def run_config(num, scale, verify=True):
    from kmer_counter.config import Options
    from kmer_counter.engine import run_count
    from kmer_counter.io.dump import load_table

    rng = np.random.default_rng(num)
    tmp = tempfile.mkdtemp(prefix=f"kc_config{num}_")
    in_dir = os.path.join(tmp, "in")
    out = os.path.join(tmp, "out.bin")

    spec = {
        # (k, canonical, n_reads, L, n_files, extra_opts)
        1: dict(k=15, canonical=False, n_reads=2_000 * scale, L=80, n_files=1),
        2: dict(k=31, canonical=True, n_reads=2_000 * scale, L=100, n_files=1),
        3: dict(k=31, canonical=True, n_reads=2_000 * scale, L=100, n_files=4),
        4: dict(k=55, canonical=False, n_reads=1_000 * scale, L=120, n_files=1),
        5: dict(k=31, canonical=True, n_reads=4_000 * scale, L=100, n_files=2),
    }[num]
    reads = make_fixture(
        in_dir, rng, spec["n_reads"], spec["L"], spec["n_files"], invalid=0.002
    )
    opts = Options(
        kmer_length=spec["k"],
        canonical=spec["canonical"],
        input_dir=in_dir,
        output_file=out,
        verbose=0,
    )
    if num == 4:
        # spill path: small table + temp dir (config 4: partitioned tables)
        opts.table_slots = 200_000
        opts.temp_dir = os.path.join(tmp, "spill")

    t0 = time.perf_counter()
    stats = run_count(opts)
    wall = time.perf_counter() - t0

    ok = None
    if verify:
        words, counts = load_table(out, spec["k"])
        want_words, want_counts = golden_table(in_dir, spec["k"], spec["canonical"])
        ok = bool(
            np.array_equal(words, want_words) and np.array_equal(counts, want_counts)
        )
    result = {
        "config": num,
        "k": spec["k"],
        "canonical": spec["canonical"],
        "files": spec["n_files"],
        "reads": reads,
        "total_kmers": stats.total_kmers,
        "distinct_kmers": stats.distinct_kmers,
        "wall_s": round(wall, 3),
        "kmers_per_s": round(stats.total_kmers / wall, 1),
        "golden_byte_exact": ok,
        "spilled_runs": stats.spilled_runs,
    }
    print(json.dumps(result), flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args()
    from kmer_counter.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    failures = 0
    for num in [int(c) for c in args.configs.split(",")]:
        result = run_config(num, args.scale, verify=not args.no_verify)
        if result["golden_byte_exact"] is False:
            failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
