#!/usr/bin/env python3
"""Smoke test of the k-mer counting path on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py           # one GPU: every phase below but "four"
    python chip_smoke.py --four    # four GPUs of one host: the mesh path only

Phases on one GPU, each byte-exact against golden.numpy_reference_dump:

  gpu-tests  ``pytest -m gpu`` in a child process, run before this process
             first touches the card (a JAX process reserves most of it).
  main       an E. coli-sized genome (4.6 Mb) sampled at 30x into 1.38M
             reads of 100 bp in 4 FASTQ files, counted at k=31 canonical
             through the CLI, once per table (tableImpl=one and two), each
             twice (cold: compiles; warm: compiled).
  hc         1.4M reads of a 140 Mb genome (~1x: most keys are singletons,
             about 67M distinct keys on the card), both tables.
  wide       k=55 forward on 200k x 150 bp reads (4 key lanes) and k=101
             canonical on 50k x 150 bp reads (7 lanes), both tables.
  spill      the main data with a small tableSlots and a tempFileLocation:
             spilled runs must be > 0.
  stages     consolidate2's stages timed at the main size, and how XLA
             lowers each of its sorts (library radix sort or generic sort).

With ``--four``: the main and hc data through the CLI on the 4-device mesh
(MeshCountEngine), both tables, and nothing else.

Every number is printed beside the card's name and power limit.  The
timings are smoke timings, not benchmark results.  The last line of stdout
is one JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".chip_smoke")

# gpuMemoryLimit for every phase: plan_chunks then sizes a 111M-slot table
# and ~397k-read chunks at k=31, L=100 — no spill without a temp dir.
MEMORY_LIMIT = 8_000_000_000
INVALID_FRAC = 0.002

# name: (reads, read length, genome length)
DATA = {
    "main": (1_380_000, 100, 4_600_000),
    "hc": (1_400_000, 100, 140_000_000),
    "k55": (200_000, 150, 4_600_000),
    "k101": (50_000, 150, 4_600_000),
}
SPILL_TABLE_SLOTS = 2_000_000


def query_card() -> str | None:
    """``name, power.limit`` of the first GPU from nvidia-smi (a child
    process that stays off JAX), or None when there is no card."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def last_line(platform: str, kind: str, count: int) -> str:
    """The result line: the only thing on the last line of stdout."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


class Smoke:
    """Shared state of one run: work dir, card label, seed, sizes and
    failures.  ``memory_limit`` is the gpuMemoryLimit of every count and
    sizes the planned shapes; ``sizes`` maps data names to (reads, read
    length, genome length)."""

    def __init__(
        self,
        work: str,
        card: str,
        seed: int = 0,
        memory_limit: int = MEMORY_LIMIT,
        sizes: dict | None = None,
    ):
        self.work = work
        self.card = card
        self.seed = seed
        self.memory_limit = memory_limit
        self.sizes = sizes or DATA
        self.failures: list[str] = []
        self._data: dict[str, str] = {}
        self._want: dict[tuple, bytes] = {}
        self._compile_s = 0.0
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self._compile_s += duration

    def close(self) -> None:
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on_event)

    def log(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}  [card: {self.card}]", flush=True)

    def check(self, phase: str, ok: bool, what: str) -> bool:
        if not ok:
            self.failures.append(f"{phase}: {what}")
            self.log(phase, f"FAIL {what}")
        return ok

    def data(self, name: str) -> str:
        """Directory of 4 seeded FASTQ files (made once per name)."""
        if name not in self._data:
            import numpy as np

            from kmer_counter.utils.seqgen import make_fastq_dir

            n_reads, read_len, genome_len = self.sizes[name]
            path = os.path.join(self.work, "data", name)
            os.makedirs(path, exist_ok=True)
            t0 = time.perf_counter()
            rng = np.random.default_rng([self.seed, list(DATA).index(name)])
            make_fastq_dir(
                path, rng, n_reads, read_len, 4, genome_len,
                invalid_frac=INVALID_FRAC,
            )
            self.log(
                name,
                f"data: {n_reads} reads x {read_len} bp from a {genome_len}-base "
                f"genome in {time.perf_counter() - t0:.1f}s (set-up)",
            )
            self._data[name] = path
        return self._data[name]

    def reference(self, phase: str, data: str, k: int, canonical: bool) -> bytes:
        """The expected dump of a dataset (computed once per key)."""
        from kmer_counter import golden

        key = (data, k, canonical)
        if key not in self._want:
            t0 = time.perf_counter()
            self._want[key] = golden.numpy_reference_dump(self.data(data), k, canonical)
            self.log(
                phase,
                f"reference k={k} canonical={canonical}: "
                f"{time.perf_counter() - t0:.1f}s",
            )
        return self._want[key]

    def run_cli(self, argv: list[str]):
        """kmer_counter.__main__.main(argv) in this process; returns
        (rc, RunStats, wall seconds, backend compile seconds)."""
        from kmer_counter import __main__ as cli
        from kmer_counter import engine

        captured = {}
        run_count = engine.run_count

        def spy(opts):
            captured["stats"] = run_count(opts)
            return captured["stats"]

        engine.run_count = spy
        c0 = self._compile_s
        t0 = time.perf_counter()
        try:
            rc = cli.main(argv)
        finally:
            engine.run_count = run_count
        wall = time.perf_counter() - t0
        return rc, captured.get("stats"), wall, self._compile_s - c0


def peak_bytes() -> str:
    import jax

    peaks = []
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        peaks.append(str(stats.get("peak_bytes_in_use", "n/a")))
    return ",".join(peaks)


def phase_count(
    smoke: Smoke,
    phase: str,
    data: str,
    k: int,
    canonical: bool,
    impls=("one", "two"),
    runs: int = 1,
    extra: tuple[str, ...] = (),
):
    """Count one dataset through the CLI with each table implementation
    and compare every dump byte for byte with the NumPy reference.
    Returns {impl: [(wall seconds, RunStats) of each passing run]}."""
    in_dir = smoke.data(data)
    want = smoke.reference(phase, data, k, canonical)
    runs_done: dict[str, list] = {}
    for impl in impls:
        for run in range(runs):
            out = os.path.join(smoke.work, f"{phase}-{impl}.bin")
            argv = [
                f"kmerLength={k}",
                f"canonical={'true' if canonical else 'false'}",
                f"inputFileLocation={in_dir}",
                f"outputFile={out}",
                f"gpuMemoryLimit={smoke.memory_limit}",
                f"tableImpl={impl}",
                *extra,
            ]
            rc, stats, wall, compile_s = smoke.run_cli(argv)
            label = f"{impl} run {run + 1}/{runs}"
            if not smoke.check(phase, rc == 0 and stats is not None, f"{label}: rc={rc}"):
                continue
            with open(out, "rb") as fh:
                exact = fh.read() == want
            smoke.check(phase, exact, f"{label}: dump differs from the reference")
            if exact:
                runs_done.setdefault(impl, []).append((wall, stats))
            smoke.log(
                phase,
                f"{label}: byte_exact={exact} wall={wall:.3f}s "
                f"kmers/s={stats.total_kmers / wall:.4g} "
                f"total={stats.total_kmers} distinct={stats.distinct_kmers} "
                f"chunks={stats.chunks} consolidations={stats.consolidations} "
                f"spilled_runs={stats.spilled_runs} compile={compile_s:.2f}s "
                f"peak_bytes_in_use={peak_bytes()} (smoke timing)",
            )
            os.remove(out)
    return runs_done


def planned_shapes(smoke: Smoke, k: int, read_len: int):
    """(reads/chunk, table slots, prefix slots, raw slots) the engines
    plan under ``smoke.memory_limit`` (CountEngine._run_two_level's
    prefix:raw split)."""
    from kmer_counter.config import Options
    from kmer_counter.engine import plan_chunks

    opts = Options(kmer_length=k, memory_limit_bytes=smoke.memory_limit)
    rpc, slots = plan_chunks(opts, read_len)
    cp = max(slots // 8, 1)
    return rpc, slots, cp, max(slots - cp, rpc * (read_len - k + 1))


def memory_analysis(smoke: Smoke, k: int, canonical: bool, read_len: int) -> None:
    """compiled.memory_analysis() of each table's chunk step and
    consolidation at the shapes plan_chunks gives the main phase."""
    import jax
    import jax.numpy as jnp

    from kmer_counter import records
    from kmer_counter.ops import table as table_ops
    from kmer_counter.ops import table2 as t2
    from kmer_counter.ops.pipeline import count_step_two_level, extract_chunk

    rpc, slots, cp, cr = planned_shapes(smoke, k, read_len)
    NL, n = records.active_lanes(k), rpc * (read_len - k + 1)
    u32, i32 = jnp.uint32, jnp.int32
    sds = jax.ShapeDtypeStruct
    reads = sds((rpc, read_len), jnp.uint8)
    one = table_ops.CountTable(sds((NL, slots), u32), sds((slots,), u32), sds((), i32))
    two = t2.TwoLevelTable(
        sds((NL, cp), u32), sds((cp,), u32), sds((NL, cr), u32), sds((), i32), sds((), u32)
    )
    lowered = {
        "one: extract_chunk": extract_chunk.lower(reads, k=k, canonical=canonical),
        "one: append": table_ops.append.lower(
            one, sds((NL, n), u32), sds((n,), u32), sds((), i32)
        ),
        "one: consolidate": table_ops.consolidate.lower(one),
        "two: count_step_two_level": count_step_two_level.lower(
            two, reads, k=k, canonical=canonical
        ),
        "two: consolidate2": t2.consolidate2.lower(two),
    }
    smoke.log("memory", f"planned shapes: reads/chunk={rpc} table_slots={slots} prefix={cp} raw={cr}")
    for name, low in lowered.items():
        m = low.compile().memory_analysis()
        smoke.log(
            "memory",
            f"{name}: argument={m.argument_size_in_bytes} output={m.output_size_in_bytes} "
            f"alias={m.alias_size_in_bytes} temp={m.temp_size_in_bytes} bytes",
        )


def _median_seconds(fn, args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sort_lowering(hlo: str) -> str:
    """How an optimized HLO module sorts: library custom calls (by target)
    and generic ``sort`` instructions."""
    import re

    targets = re.findall(r'custom_call_target="([^"]*)"', hlo)
    sorts = [t for t in targets if "sort" in t.lower()]
    generic = len(
        re.findall(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=.*?\ssort\(", hlo, re.M)
    )
    return f"custom-call sorts={sorts or 'none'} generic sort ops={generic}"


def phase_stages(
    smoke: Smoke, k: int = 31, read_len: int = 100, distinct: int = 4_600_000,
    reps: int = 5,
) -> None:
    """Time consolidate2's stages at the main size on a steady-state table:
    the prefix holds ``distinct`` sorted keys, the raw region is full of
    keys drawn from them.  Also reports how XLA lowers each sort."""
    import jax
    import jax.numpy as jnp

    from kmer_counter import records
    from kmer_counter.ops import table2 as t2
    from kmer_counter.ops.sortcount import device_sort

    _, _, cp, cr = planned_shapes(smoke, k, read_len)
    NL = records.active_lanes(k)
    distinct = min(distinct, cp)
    key = jax.random.key(smoke.seed)
    k1, k2 = jax.random.split(key)
    pool = jax.random.bits(k1, (NL, distinct), jnp.uint32) & jnp.uint32(0x7FFFFFFF)
    pool = jnp.stack(device_sort(tuple(pool), NL))
    p_lanes = jnp.zeros((NL, cp), jnp.uint32).at[:, :distinct].set(pool)
    p_counts = jnp.zeros((cp,), jnp.uint32).at[:distinct].set(30)
    raw = jnp.take(pool, jax.random.randint(k2, (cr,), 0, distinct), axis=1)
    raw_off = jnp.int32(cr)

    collapse = jax.jit(t2._collapse_prefix)
    raw_sort = jax.jit(lambda r: device_sort(tuple(r), NL))
    reduce_raw = jax.jit(t2._reduce_raw)
    c_lanes, c_counts = collapse(p_lanes, p_counts)
    r_lanes, r_counts = reduce_raw(raw, raw_off)
    m_lanes = jnp.concatenate([c_lanes, r_lanes], axis=1)
    m_counts = jnp.concatenate([c_counts, r_counts])
    merge_sort = jax.jit(lambda l, c: device_sort((*l, c), NL))
    stages = {
        f"_collapse_prefix ({cp} rows)": (collapse, (p_lanes, p_counts)),
        f"_reduce_raw's {NL}-operand sort ({cr} rows)": (raw_sort, (raw,)),
        f"_reduce_raw ({cr} rows)": (reduce_raw, (raw, raw_off)),
        f"{NL + 1}-operand merge sort ({cp + cr} rows)": (merge_sort, (m_lanes, m_counts)),
    }
    for name, (fn, args) in stages.items():
        seconds = _median_seconds(fn, args, reps)
        hlo = fn.lower(*args).compile().as_text()
        smoke.log("stages", f"{name}: {seconds * 1e3:.3f} ms median of {reps}; {sort_lowering(hlo)}")

    table = t2.TwoLevelTable(p_lanes, p_counts, raw, raw_off, jnp.uint32(0))
    hlo = t2.consolidate2.lower(table).compile().as_text()
    times = []
    for _ in range(reps + 1):
        fresh = jax.block_until_ready(jax.tree.map(jnp.copy, table))
        t0 = time.perf_counter()
        out, live, lost = jax.block_until_ready(t2.consolidate2(fresh))
        times.append(time.perf_counter() - t0)
    # Every pool key sits in the prefix and (almost surely) in the raw
    # region: up to two live rows per key after the merge, none lost.
    smoke.check(
        "stages",
        int(lost) == 0 and distinct <= int(live) <= 2 * distinct,
        f"consolidate2 live={int(live)} lost={int(lost)}",
    )
    smoke.log(
        "stages",
        f"consolidate2 whole ({cp}+{cr} rows): {statistics.median(times[1:]) * 1e3:.3f} ms "
        f"median of {reps}; {sort_lowering(hlo)}",
    )


def run_one_gpu(smoke: Smoke) -> None:
    done = phase_count(smoke, "main", "main", 31, True, runs=2)
    for impl, runs in done.items():
        smoke.log(
            "main",
            f"tableImpl={impl}: wall cold={runs[0][0]:.3f}s "
            f"warm={runs[-1][0]:.3f}s (smoke timing)",
        )
    memory_analysis(smoke, 31, True, smoke.sizes["main"][1])
    phase_count(smoke, "hc", "hc", 31, True)
    phase_count(smoke, "wide-k55", "k55", 55, False)
    phase_count(smoke, "wide-k101", "k101", 101, True)
    spill_phase(smoke)
    phase_stages(smoke)


def spill_phase(smoke: Smoke, table_slots: int = SPILL_TABLE_SLOTS) -> None:
    spill_dir = os.path.join(smoke.work, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    done = phase_count(
        smoke,
        "spill",
        "main",
        31,
        True,
        impls=("auto",),
        extra=(f"tableSlots={table_slots}", f"tempFileLocation={spill_dir}"),
    )
    spilled = [stats.spilled_runs for _, stats in done.get("auto", [])]
    smoke.check("spill", bool(spilled) and min(spilled) > 0, f"spilled runs {spilled}")


def run_four_gpus(smoke: Smoke) -> None:
    for data in ("main", "hc"):
        phase_count(smoke, f"four-{data}", data, 31, True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="the 4-GPU mesh path only")
    ap.add_argument("--seed", type=int, default=0, help="seed of every dataset")
    args = ap.parse_args(argv)
    want = 4 if args.four else 1

    if not os.path.isdir(os.path.join(HERE, "kmer_counter")):
        print(f"error: no kmer_counter package beside {__file__}", file=sys.stderr)
        return 2
    if HERE not in sys.path:
        sys.path.insert(0, HERE)

    card = query_card()
    if card is None:
        import jax

        print(
            f"error: no GPU (nvidia-smi found none; JAX runs on "
            f"{jax.devices()[0].platform})",
            file=sys.stderr,
        )
        return 1
    print(f"card: {card}", flush=True)
    if not args.four:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    build = subprocess.run(
        ["make", "-C", os.path.join(HERE, "native"), "-B"],
        capture_output=True,
        text=True,
    )
    print(f"[setup] native build rc={build.returncode}", flush=True)
    failures = []
    if not args.four:
        t0 = time.perf_counter()
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-p", "no:cacheprovider", "tests"],
            cwd=HERE,
            capture_output=True,
            text=True,
            timeout=900,
        )
        tail = tests.stdout.strip().splitlines()[-12:]
        print("\n".join(f"[gpu-tests] {line}" for line in tail), flush=True)
        print(f"[gpu-tests] rc={tests.returncode} in {time.perf_counter() - t0:.1f}s  [card: {card}]", flush=True)
        if tests.returncode != 0:
            failures.append(f"gpu-tests: rc={tests.returncode}")

    import jax

    from kmer_counter.io import native
    from kmer_counter.utils.compile_cache import enable_compile_cache

    print(f"[setup] compile cache: {enable_compile_cache()}", flush=True)
    print(f"[setup] parser: {'native' if native.available() else 'python'}", flush=True)
    devices = jax.devices()
    dev = devices[0]
    print(f"[setup] devices: platform={dev.platform} kind={dev.device_kind} count={len(devices)}", flush=True)
    if dev.platform != "gpu" or len(devices) != want:
        print(f"error: need {want} GPU(s), JAX has {len(devices)} {dev.platform} device(s)", file=sys.stderr)
        return 1

    shutil.rmtree(WORK, ignore_errors=True)
    smoke = Smoke(WORK, card, args.seed)
    smoke.failures.extend(failures)
    try:
        if args.four:
            run_four_gpus(smoke)
        else:
            run_one_gpu(smoke)
    finally:
        smoke.close()
        shutil.rmtree(WORK, ignore_errors=True)

    print(f"card: {card}", flush=True)
    if smoke.failures:
        print("FAILED: " + "; ".join(smoke.failures), flush=True)
        return 1
    print(last_line(dev.platform, dev.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
