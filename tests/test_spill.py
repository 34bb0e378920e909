"""Spill-merge subsystem tests (io.spill) and engine spill integration."""

import os

import numpy as np
import pytest

from kmer_counter import golden, records
from kmer_counter.io.spill import MergeScheduler, RunReader, merge_runs, write_run


def make_run(tmp_path, name, counter, k):
    words, counts = golden.table_from_counter(counter)
    lanes = records.words_to_lanes(words)
    return write_run(str(tmp_path / name), lanes, counts)


def read_all(path, k):
    from kmer_counter.io.dump import load_table

    words, counts = load_table(path, k)
    return {tuple(w): int(c) for w, c in zip(words.tolist(), counts.tolist())}


def test_run_reader_premerges_adjacent(tmp_path):
    # A run with adjacent duplicate keys (as the reference's SortedKMerFile
    # expects from unreduced sorted spills) is pre-merged on read.
    k = 4
    words = records.pack_codes(
        np.array([[0, 1, 2, 3], [0, 1, 2, 3], [1, 1, 1, 1]]), k
    )
    lanes = records.words_to_lanes(words)
    counts = np.array([2, 3, 7], np.uint32)
    path = write_run(str(tmp_path / "r.run"), lanes, counts)
    reader = RunReader(path, k)
    first = reader.peek()
    assert first == reader.peek()  # peek is idempotent
    key, count = reader.pop()
    assert count == 5
    assert reader.pop()[1] == 7
    assert reader.pop() is None
    assert reader.peek() is None


def test_merge_runs_sums_counts(tmp_path, rng):
    k = 15
    c1 = golden.count_reads(["".join(rng.choice(list("ACGT"), 50)) for _ in range(8)], k)
    c2 = golden.count_reads(["".join(rng.choice(list("ACGT"), 50)) for _ in range(8)], k)
    shared = list(c1.keys())[0]
    c2[shared] = c2.get(shared, 0) + 11
    p1 = make_run(tmp_path, "a.run", c1, k)
    p2 = make_run(tmp_path, "b.run", c2, k)
    out = str(tmp_path / "merged.bin")
    n = merge_runs([p1, p2], out, k)
    want = dict(c1)
    for key, c in c2.items():
        want[key] = want.get(key, 0) + c
    got = read_all(out, k)
    assert got == want
    assert n == len(want)
    # output is sorted
    words, _ = __import__(
        "kmer_counter.io.dump", fromlist=["load_table"]
    ).load_table(out, k)
    keys = list(map(tuple, words.tolist()))
    assert keys == sorted(keys)


def test_merge_scheduler_hierarchical(tmp_path, rng):
    k = 9
    runs = []
    want = {}
    sched = MergeScheduler(str(tmp_path / "tmp"), k, fan_in=2, threads=2)
    for i in range(7):
        c = golden.count_reads(
            ["".join(rng.choice(list("ACGT"), 30)) for _ in range(4)], k
        )
        for key, v in c.items():
            want[key] = want.get(key, 0) + v
        sched.add_run(make_run(tmp_path, f"run{i}.run", c, k))
    out = str(tmp_path / "out.bin")
    n = sched.finish(out)
    got = read_all(out, k)
    assert got == want
    assert n == len(want)
    # intermediates cleaned up
    leftovers = [f for f in os.listdir(tmp_path / "tmp") if f.endswith(".run")]
    assert leftovers == []


def test_engine_spill_path(tmp_path, rng):
    from test_engine import golden_dir_table, run_engine

    (tmp_path / "in").mkdir()
    from test_ingest import random_seqs, write_fastq

    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 80, 40))
    (words, counts), stats = run_engine(
        tmp_path,
        15,
        reads_per_chunk=4,
        table_slots=400,
        temp_dir=str(tmp_path / "tmp"),
    )
    assert stats.spilled_runs >= 2  # at least one mid-run spill + final
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_merge_scheduler_surfaces_failures(tmp_path, rng, monkeypatch):
    # A failing background merge must re-queue its batch and raise at
    # finish() — never silently drop records from the output.
    import kmer_counter.io.spill as spill_mod

    k = 9
    sched = MergeScheduler(str(tmp_path / "tmp"), k, fan_in=2, threads=1)
    real_merge = spill_mod.merge_runs
    calls = {"n": 0}

    def flaky(paths, out, kk, **kw):
        calls["n"] += 1
        raise OSError("disk full (injected)")

    monkeypatch.setattr(spill_mod, "merge_runs", flaky)
    for i in range(4):
        c = golden.count_reads(
            ["".join(rng.choice(list("ACGT"), 30)) for _ in range(3)], k
        )
        sched.add_run(make_run(tmp_path, f"r{i}.run", c, k))
    import pytest as _pytest

    monkeypatch.setattr(spill_mod, "merge_runs", real_merge)  # finish path ok
    # wait for the background failure to land, then finish must raise
    import time

    deadline = time.time() + 5
    while time.time() < deadline and sched._pending:
        time.sleep(0.01)
    if sched._errors:
        with _pytest.raises(RuntimeError, match="background merge"):
            sched.finish(str(tmp_path / "out.bin"))
    else:
        _pytest.skip("background merge won the race before injection")
