"""Mesh scaling-efficiency harness — BASELINE.json's ">=80% scaling
efficiency" target, measured over 1, 2 and 4 GPUs of one host.

For each device count D it drives the sharded counter (parallel.pipeline)
through a steady-state loop of data-parallel chunk steps with
consolidations amortized in (the same convention as bench.py), waits for
the whole counter state with ``block_until_ready``, and reports k-mers/s
plus the efficiency relative to perfect linear scaling from the smallest
measured D:

    {"metric": "scaling", "unit": "kmers/s", "backend": ...,
     "device_kind": ..., "results": [{"devices": D, "kmers_per_s": X,
     "efficiency": E}, ...]}

On the virtual CPU mesh (JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=8) the run is a correct-shape check
of the harness — virtual devices share host cores, so CPU "efficiency" is
not a hardware claim (tests/test_bench_smoke.py runs exactly that).

Reference role: the reference has no multi-device story at all (SURVEY.md
§2.3 — no MPI/NCCL anywhere; its only scale-out was the dormant disk
merge tree, KMerFileMergeHandler.cpp:49-100).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _measure_one(D, k, canonical, reads_per_device, L, chunks, warmup, impl):
    import jax

    from kmer_counter.parallel.mesh import make_mesh
    from kmer_counter.parallel.pipeline import (
        ShardedCounter,
        ShardedCounter2,
    )

    from jax.sharding import NamedSharding, PartitionSpec

    mesh = make_mesh(D)
    P = L - k + 1
    chunk_slots = reads_per_device * P
    rng = np.random.default_rng(0)
    # Distinct chunks (sampled from one genome) so consolidations see a
    # realistic mix of repeats, like bench.py's steady-state phases.
    genome = rng.choice(
        np.frombuffer(b"ACGT", dtype=np.uint8), size=4_000_000
    )
    n_rows = D * reads_per_device
    n_distinct = 4
    # Pre-stage the chunks on-device OUTSIDE the timed loop (counter.step
    # passes jax.Arrays through): the measurement isolates device +
    # collective throughput.  Host ingest is measured separately
    # (benchmarks/bench_ingest.py).
    sharding = NamedSharding(mesh, PartitionSpec("data"))
    read_sets = []
    for _ in range(n_distinct):
        st = rng.integers(0, len(genome) - L, size=n_rows)
        read_sets.append(
            jax.device_put(genome[st[:, None] + np.arange(L)[None, :]], sharding)
        )

    # Pre-size the table for the WORST-case cardinality of the whole run
    # (every window distinct): prefix growth mid-measurement rebuilds the
    # jitted consolidation at a new shape, and the compile would land in
    # the timed window.  The engine pre-sizes from the memory budget for
    # the same reason (plan_chunks).
    total_chunks = chunks + warmup + 1
    if impl == "two":
        counter = ShardedCounter2(
            mesh,
            k,
            canonical,
            prefix_slots=total_chunks * chunk_slots,
            raw_slots=8 * chunk_slots,
            reads_per_device=reads_per_device,
            line_length=L,
        )
    else:
        counter = ShardedCounter(
            mesh,
            k,
            canonical,
            table_slots=(total_chunks + 2) * chunk_slots,
            reads_per_device=reads_per_device,
            line_length=L,
        )

    def drain():
        if impl == "two":
            jax.block_until_ready(
                (counter.prefix_lanes, counter.prefix_counts, counter.raw_lanes)
            )
        else:
            jax.block_until_ready((counter.lanes, counter.counts))

    for i in range(warmup):
        counter.step(read_sets[i % n_distinct])
    counter.consolidate()
    drain()

    t0 = time.perf_counter()
    for i in range(chunks):
        counter.step(read_sets[i % n_distinct])
    counter.consolidate()
    drain()
    dt = time.perf_counter() - t0
    kmers = chunks * D * chunk_slots
    return kmers / dt


def run_scaling(
    device_counts,
    k=31,
    canonical=True,
    reads_per_device=2048,
    line_length=100,
    chunks=8,
    warmup=2,
    impl="auto",
):
    """Measure throughput at each device count; returns the results dict
    (the JSON schema above)."""
    import jax

    from kmer_counter.engine import use_two_level
    from kmer_counter.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    impl = "two" if use_two_level(impl) else "one"
    avail = len(jax.devices())
    results = []
    base = None
    for D in device_counts:
        if D > avail:
            print(
                json.dumps(
                    {"devices": D, "skipped": f"only {avail} devices"}
                ),
                flush=True,
            )
            continue
        rate = _measure_one(
            D, k, canonical, reads_per_device, line_length, chunks, warmup,
            impl,
        )
        if base is None:
            base = (D, rate)
        eff = rate / (base[1] * D / base[0])
        results.append(
            {
                "devices": D,
                "kmers_per_s": round(rate, 1),
                "efficiency": round(eff, 4),
            }
        )
        print(json.dumps(results[-1]), flush=True)
    return {
        "metric": "scaling",
        "unit": "kmers/s",
        "backend": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "k": k,
        "canonical": canonical,
        "impl": impl,
        "results": results,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--devices",
        default="1,2,4",
        help="comma-separated device counts to measure",
    )
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--forward", action="store_true", help="disable canonical")
    ap.add_argument("--reads-per-device", type=int, default=2048)
    ap.add_argument("--line-length", type=int, default=100)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--impl", choices=["auto", "one", "two"], default="auto")
    ap.add_argument("--json-out", default="", help="also write the summary here")
    args = ap.parse_args(argv)
    summary = run_scaling(
        [int(d) for d in args.devices.split(",")],
        k=args.k,
        canonical=not args.forward,
        reads_per_device=args.reads_per_device,
        line_length=args.line_length,
        chunks=args.chunks,
        warmup=args.warmup,
        impl=args.impl,
    )
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
