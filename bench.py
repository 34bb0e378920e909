"""Benchmark: k-mers counted per second per device (BASELINE.json north star).

Measures the steady-state per-chunk loop on the default device: encode →
extract → canonical → table append, with the consolidations amortized in —
the engine's hot path — on synthetic 100-base reads at k=31 canonical
(BASELINE.json config 2).  Phases: "one" (one-level table, ops.table),
"two" (two-level table, ops.table2 with consolidate2) and "hc" (the
two-level table in the high-cardinality regime, a side metric on stderr).

Prints ONE JSON line:
  {"metric": "kmers_per_sec_per_chip_k31", "value": ..., "unit": "kmers/s",
   "vs_baseline": ..., "platform": ..., "device_kind": ..., "device_count": ...}

``vs_baseline`` is measured, not copied: the reference publishes no numbers
and its CUDA binary cannot run here, so the baseline proxy is the same
workload executed by the best host-side implementation of the reference's
*active* aggregation design (NumPy vectorized extract + sort — generous to
the reference, whose actual path is a single-thread -O0 hash insert loop).
vs_baseline = device_throughput / host_proxy_throughput.

A device other than a GPU is an error unless ``JAX_PLATFORMS`` names the
platform explicitly (the CPU smoke test does).  Any failing phase fails the
run.

Env knobs: BENCH_READS (default 262144), BENCH_ITERS (8), BENCH_K (31),
BENCH_CANONICAL (1), BENCH_LINE_LEN (100), BENCH_GENOME (1000000),
BENCH_GENOME_HC, BENCH_CAP_MULT (8), BENCH_PHASES ("one,two,hc").  The
compile cache is kmer_counter.utils.compile_cache's.
"""

import json
import os
import sys
import time

import numpy as np

_T0 = time.perf_counter()


def _log(msg):
    print(f"[bench +{time.perf_counter() - _T0:5.1f}s] {msg}", file=sys.stderr)
    sys.stderr.flush()


def host_proxy_throughput(reads, k, canonical):
    """Reference-semantics counter in vectorized NumPy (sort-count)."""
    from kmer_counter import records

    t0 = time.perf_counter()
    codes, _ = records.encode_bases(reads)
    R, L = codes.shape
    P = L - k + 1
    idx = np.arange(P)[:, None] + np.arange(k)[None, :]
    windows = codes[:, idx]  # [R, P, k]
    words = records.pack_codes(windows.reshape(R * P, k), k)
    if canonical:
        words = records.canonical_words(words, k)
    # sort + adjacent reduce (the dormant reference design, on host)
    order = np.lexsort(tuple(words[:, w] for w in reversed(range(words.shape[1]))))
    swords = words[order]
    boundary = np.concatenate(
        [[True], (swords[1:] != swords[:-1]).any(axis=1)]
    )
    np.add.reduceat(np.ones(len(swords), np.uint32), np.flatnonzero(boundary))
    dt = time.perf_counter() - t0
    return (R * P) / dt


def _measure(step, table, iters, label):
    """Warm up (compiles), then best-of-3 timed reps of ``iters`` chunks,
    each ending in ``block_until_ready`` on the whole table state."""
    import jax

    t0 = time.perf_counter()
    for _ in range(4):
        table = step(table)
    jax.block_until_ready(table)
    _log(f"{label}: compile+warmup {time.perf_counter() - t0:.1f}s")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            table = step(table)
        jax.block_until_ready(table)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    n_reads = int(os.environ.get("BENCH_READS", 262144))
    iters = int(os.environ.get("BENCH_ITERS", 8))
    k = int(os.environ.get("BENCH_K", 31))
    canonical = os.environ.get("BENCH_CANONICAL", "1") == "1"
    L = int(os.environ.get("BENCH_LINE_LEN", 100))
    if L < k:
        raise SystemExit(
            f"BENCH_LINE_LEN={L} < BENCH_K={k}: no k-mers can be extracted "
            f"(set BENCH_LINE_LEN > k, e.g. BENCH_LINE_LEN={k + 49})"
        )
    phases = os.environ.get("BENCH_PHASES", "one,two,hc").split(",")
    metric = f"kmers_per_sec_per_chip_k{k}"

    import jax
    import jax.numpy as jnp

    from kmer_counter.ops import extract_chunk
    from kmer_counter.ops import table as table_ops
    from kmer_counter.ops import table2 as t2
    from kmer_counter.ops.pipeline import count_step_two_level
    from kmer_counter.records import active_lanes
    from kmer_counter.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = jax.devices()[0]
    if device.platform != "gpu" and not os.environ.get("JAX_PLATFORMS"):
        raise SystemExit(
            f"no GPU: JAX runs on {device.platform}; set JAX_PLATFORMS to "
            "measure another platform on purpose"
        )

    cap_mult = int(os.environ.get("BENCH_CAP_MULT", 8))
    rng = np.random.default_rng(0)
    # Genome-like workload: reads sampled from a fixed reference sequence so
    # k-mer multiplicity matches real coverage (~reads*L/genome_len x),
    # exercising consolidation exactly as the engine does.
    genome_len = int(os.environ.get("BENCH_GENOME", 1_000_000))
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=genome_len)
    starts = rng.integers(0, genome_len - L, size=n_reads)
    reads = genome[starts[:, None] + np.arange(L)[None, :]]
    P = L - k + 1
    kmers_per_chunk = n_reads * P
    capacity = 4 * kmers_per_chunk
    _log(
        f"device={device} kind={device.device_kind} reads={n_reads} L={L} "
        f"k={k} canonical={canonical} kmers/chunk={kmers_per_chunk} "
        f"table={capacity} slots"
    )

    # Host proxy: best-of-3 (the first NumPy pass can be slow on a cold
    # allocator/cache), at a fixed size so vs_baseline stays comparable.
    proxy_reads = reads[:1024]
    proxy_rate = max(
        host_proxy_throughput(proxy_reads, k, canonical) for _ in range(3)
    )
    _log(f"host proxy {proxy_rate / 1e6:.2f}M kmers/s")

    dev_reads = jax.device_put(jnp.asarray(reads), device)
    n_scalar = jnp.int32(kmers_per_chunk)
    results = {}

    def run_one_level_phase():
        # One-level table (ops.table): every consolidation re-sorts the
        # whole table through sort_reduce.
        table = jax.device_put(
            table_ops.make_table(capacity, active_lanes(k)), device
        )
        state = {"bound": 0, "consolidations": 0}

        def step1(table):
            if state["bound"] + kmers_per_chunk > capacity:
                table = table_ops.consolidate(table)
                state["bound"] = int(jax.device_get(table.offset))
                state["consolidations"] += 1
            lanes, counts = extract_chunk(dev_reads, k, canonical)
            table = table_ops.append(table, lanes, counts, n_scalar)
            state["bound"] += kmers_per_chunk
            return table

        dt = _measure(step1, table, iters, "one-level")
        rate = iters * kmers_per_chunk / dt
        _log(
            f"one-level: {dt / iters * 1e3:.1f}ms/chunk -> "
            f"{rate / 1e6:.1f}M kmers/s "
            f"({state['consolidations']} consolidations)"
        )
        return rate

    def run_two_level_phase(label, chunks=None, prefix_mult=1):
        # Two-level table (ops.table2): keys-only raw appends, consolidate2
        # merges the raw region into the prefix.  ``chunks``: device read
        # arrays cycled per step (a single repeated chunk keeps cardinality
        # low; distinct chunks sampled from a large genome drive the
        # high-cardinality regime).  ``prefix_mult``: prefix slots as a
        # multiple of kmers_per_chunk, pre-sized for the steady-state live
        # bound so growth never recompiles mid-measurement.
        if chunks is None:
            chunks = [dev_reads]
        cp = prefix_mult * kmers_per_chunk  # all distinct keys must fit
        # Raw region: cap_mult-1 chunks per consolidation.
        cr = cap_mult * kmers_per_chunk - kmers_per_chunk
        iters2 = cr // kmers_per_chunk  # one full cycle per timed rep
        table = jax.device_put(t2.make_table2(cp, cr, active_lanes(k)), device)
        state = {"bound": 0, "consolidations": 0, "step": 0}

        def step2(table):
            if state["bound"] + kmers_per_chunk > cr:
                table, live, lost = t2.consolidate2(table)
                state["bound"] = 0
                state["consolidations"] += 1
            reads_i = chunks[state["step"] % len(chunks)]
            state["step"] += 1
            table = count_step_two_level(table, reads_i, k, canonical)
            state["bound"] += kmers_per_chunk
            return table

        dt = _measure(step2, table, iters2, label)
        rate = iters2 * kmers_per_chunk / dt
        _log(
            f"{label}: {dt / iters2 * 1e3:.1f}ms/chunk -> "
            f"{rate / 1e6:.1f}M kmers/s "
            f"({state['consolidations']} consolidations)"
        )
        return rate

    if "one" in phases:
        results["one"] = run_one_level_phase()
    if "two" in phases:
        results["two"] = run_two_level_phase("two-level")
    if "hc" in phases:
        # High-cardinality regime (BASELINE.json config 4's shape): chunks
        # sampled from a genome large enough that the live prefix
        # approaches CP = cap_mult x chunk windows, so consolidations merge
        # a large live prefix.
        genome_hc = int(
            os.environ.get(
                "BENCH_GENOME_HC", max(48_000_000, cap_mult * kmers_per_chunk)
            )
        )
        g2 = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=genome_hc)
        hc_chunks = []
        for _ in range(cap_mult):
            st = rng.integers(0, genome_hc - L, size=n_reads)
            hc_chunks.append(
                jax.device_put(
                    jnp.asarray(g2[st[:, None] + np.arange(L)[None, :]]), device
                )
            )
        del g2
        rate = run_two_level_phase(
            "two-level-hc", chunks=hc_chunks, prefix_mult=cap_mult
        )
        del hc_chunks
        # Side metric: on stderr only — stdout stays ONE JSON line.
        _log(
            "side metric: "
            + json.dumps(
                {
                    "metric": f"{metric}_highcard",
                    "value": round(rate, 1),
                    "unit": "kmers/s",
                    "vs_baseline": round(rate / proxy_rate, 2),
                }
            )
        )

    if not results:
        raise SystemExit(f"no headline phase in BENCH_PHASES={phases}")
    best = max(results.values())
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(best, 1),
                "unit": "kmers/s",
                "vs_baseline": round(best / proxy_rate, 2),
                "platform": device.platform,
                "device_kind": device.device_kind,
                "device_count": len(jax.devices()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
