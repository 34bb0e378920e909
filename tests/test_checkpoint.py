"""Checkpoint/resume and metrics tests."""

import json
import os

import numpy as np
import pytest

from kmer_counter import checkpoint, golden, records
from kmer_counter.config import Options
from kmer_counter.metrics import Metrics, SizeMonitor

from test_engine import golden_dir_table, run_engine
from test_ingest import random_seqs, write_fastq


def test_checkpoint_save_load_roundtrip(tmp_path, rng):
    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file="x")
    counter = golden.count_reads(
        ["".join(rng.choice(list("ACGT"), 40)) for _ in range(6)], 15
    )
    words, counts = golden.table_from_counter(counter)
    lanes = records.words_to_lanes(words)
    checkpoint.save(
        str(tmp_path / "ck"), opts, lanes, counts, reads_absorbed=6,
        files={"a.fastq": 6}, allt=3,
    )
    out = checkpoint.load(str(tmp_path / "ck"), opts)
    assert out is not None
    np.testing.assert_array_equal(out.lanes, lanes)
    np.testing.assert_array_equal(out.counts, counts)
    assert out.reads_absorbed == 6
    assert out.files == {"a.fastq": 6}
    assert out.allt == 3


def test_checkpoint_config_mismatch_ignored(tmp_path, rng):
    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file="x")
    words = records.pack_codes(np.zeros((1, 15), int), 15)
    checkpoint.save(
        str(tmp_path / "ck"), opts, records.words_to_lanes(words),
        np.array([1], np.uint32), 3,
    )
    other = Options(kmer_length=17, input_dir=str(tmp_path), output_file="x")
    assert checkpoint.load(str(tmp_path / "ck"), other) is None
    assert checkpoint.load(str(tmp_path / "missing"), opts) is None


def test_engine_writes_checkpoints(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 64, 40))
    ck = tmp_path / "ck"
    (words, counts), stats = run_engine(
        tmp_path, 15, reads_per_chunk=4, table_slots=600,
        checkpoint_dir=str(ck), checkpoint_every=1,
    )
    assert (ck / "checkpoint.json").exists()
    manifest = json.loads((ck / "checkpoint.json").read_text())
    assert 0 < manifest["reads_absorbed"] <= 64
    # Output still exact.
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)


def test_engine_resume_from_checkpoint(tmp_path, rng):
    # Simulate a crash after file a was absorbed: checkpoint holds golden(a),
    # resume must process only b and produce golden(a)+golden(b).
    (tmp_path / "in").mkdir()
    seqs_a = random_seqs(rng, 10, 40)
    seqs_b = random_seqs(rng, 12, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a)
    write_fastq(tmp_path / "in" / "b.fastq", seqs_b)
    opts = Options(
        kmer_length=15,
        input_dir=str(tmp_path / "in"),
        output_file=str(tmp_path / "out.bin"),
        checkpoint_dir=str(tmp_path / "ck"),
        verbose=0,
    )
    counter_a = golden.count_reads(seqs_a, 15)
    words_a, counts_a = golden.table_from_counter(counter_a)
    checkpoint.save(
        str(tmp_path / "ck"), opts,
        records.words_to_lanes(words_a), counts_a, reads_absorbed=10,
    )
    from kmer_counter.engine import CountEngine

    stats = CountEngine(opts).run()
    assert stats.reads == 22  # 10 resumed + 12 processed
    from kmer_counter.io.dump import load_table

    words, counts = load_table(str(tmp_path / "out.bin"), 15)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_engine_two_level_resume(tmp_path, rng):
    # Same crash-resume scenario on the two-level table path (the fast
    # path and checkpointing were mutually exclusive in round 2).
    (tmp_path / "in").mkdir()
    seqs_a = random_seqs(rng, 10, 40)
    seqs_b = random_seqs(rng, 12, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a)
    write_fastq(tmp_path / "in" / "b.fastq", seqs_b)
    opts = Options(
        kmer_length=15,
        input_dir=str(tmp_path / "in"),
        output_file=str(tmp_path / "out.bin"),
        checkpoint_dir=str(tmp_path / "ck"),
        table_impl="two",
        verbose=0,
    )
    counter_a = golden.count_reads(seqs_a, 15)
    words_a, counts_a = golden.table_from_counter(counter_a)
    checkpoint.save(
        str(tmp_path / "ck"), opts,
        records.words_to_lanes(words_a), counts_a, reads_absorbed=10,
        files={"a.fastq": 10},
    )
    from kmer_counter.engine import CountEngine

    stats = CountEngine(opts).run()
    assert stats.reads == 22
    from kmer_counter.io.dump import load_table

    words, counts = load_table(str(tmp_path / "out.bin"), 15)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_engine_two_level_writes_checkpoints(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 64, 40))
    ck = tmp_path / "ck"
    (words, counts), stats = run_engine(
        tmp_path, 15, reads_per_chunk=4, table_slots=600,
        checkpoint_dir=str(ck), checkpoint_every=1, table_impl="two",
    )
    assert (ck / "checkpoint.json").exists()
    manifest = json.loads((ck / "checkpoint.json").read_text())
    assert 0 < manifest["reads_absorbed"] <= 64
    assert manifest["files"] == {"a.fastq": manifest["reads_absorbed"]}
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("impl", ["one", "two"])
def test_engine_resume_detects_ingest_drift(tmp_path, rng, impl):
    # The checkpoint says 10 reads were absorbed from a.fastq; if a.fastq
    # has silently changed (here: fewer reads), the positional skip would
    # misalign — the per-file manifest must catch it.
    (tmp_path / "in").mkdir()
    seqs_a = random_seqs(rng, 10, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a[:4])  # drifted file
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 12, 40))
    opts = Options(
        kmer_length=15,
        input_dir=str(tmp_path / "in"),
        output_file=str(tmp_path / "out.bin"),
        checkpoint_dir=str(tmp_path / "ck"),
        table_impl=impl,
        verbose=0,
    )
    words_a, counts_a = golden.table_from_counter(
        golden.count_reads(seqs_a, 15)
    )
    checkpoint.save(
        str(tmp_path / "ck"), opts,
        records.words_to_lanes(words_a), counts_a, reads_absorbed=10,
        files={"a.fastq": 10},
    )
    from kmer_counter.engine import CountEngine

    with pytest.raises(RuntimeError, match="resume drift"):
        CountEngine(opts).run()


def test_metrics_and_monitor(capsys):
    m = Metrics()
    m.count("chunks")
    m.count("chunks", 2)
    with m.timer("stage"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["chunks"] == 3
    assert snap["timer_calls"]["stage"] == 1
    assert "stage" in json.loads(m.report())["timers_s"]
    import time

    with SizeMonitor(lambda: "gauge=42", interval_s=0.05):
        time.sleep(0.2)
    assert "gauge=42" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["one", "two"])
def test_engine_checkpoints_through_spill(tmp_path, rng, impl):
    """Round-4 item: checkpoints continue once disk spill engages — the
    manifest records the quiescent spill-run set.  After a SUCCESSFUL run
    the scheduler has consumed those files, so the stale snapshot must be
    refused (a resume would otherwise silently lose the spilled counts)."""
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 96, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    ck, tmpdir = tmp_path / "ck", tmp_path / "tmp"
    opts = Options(
        kmer_length=15,
        input_dir=str(tmp_path / "in"),
        output_file=str(tmp_path / "out.bin"),
        checkpoint_dir=str(ck),
        checkpoint_every=1,
        temp_dir=str(tmpdir),
        table_impl=impl,
        reads_per_chunk=8,
        table_slots=600,  # tiny: forces spill instead of growth
        verbose=0,
    )
    from kmer_counter.engine import CountEngine

    stats = CountEngine(opts).run()
    assert stats.spilled_runs > 0, "precondition: the run must spill"
    manifest = json.loads((ck / "checkpoint.json").read_text())
    assert manifest.get("spill_runs"), "snapshot must list the spill runs"
    # run finished: its merge consumed the listed files -> snapshot stale
    assert checkpoint.load(str(ck), opts) is None
    from kmer_counter.io.dump import load_table

    words, counts = load_table(str(tmp_path / "out.bin"), 15)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("impl", ["one", "two"])
def test_engine_resume_across_spill(tmp_path, rng, impl):
    """Crash-after-spill resume: the snapshot holds only the post-spill
    partial table plus the spill-run manifest; resume must re-register the
    runs with the scheduler and produce the full golden table."""
    from kmer_counter.io import spill as spill_io

    (tmp_path / "in").mkdir()
    seqs_a = random_seqs(rng, 8, 40)   # spilled before the snapshot
    seqs_b = random_seqs(rng, 6, 40)   # in the snapshot table
    seqs_c = random_seqs(rng, 10, 40)  # unprocessed at crash time
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a + seqs_b + seqs_c)
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    opts = Options(
        kmer_length=15,
        input_dir=str(tmp_path / "in"),
        output_file=str(tmp_path / "out.bin"),
        checkpoint_dir=str(tmp_path / "ck"),
        temp_dir=str(tmpdir),
        table_impl=impl,
        verbose=0,
    )
    words_a, counts_a = golden.table_from_counter(
        golden.count_reads(seqs_a, 15)
    )
    run = spill_io.write_run(
        str(tmpdir / "spill_000001.run"),
        records.words_to_lanes(words_a),
        counts_a,
    )
    words_b, counts_b = golden.table_from_counter(
        golden.count_reads(seqs_b, 15)
    )
    checkpoint.save(
        str(tmp_path / "ck"), opts,
        records.words_to_lanes(words_b), counts_b,
        reads_absorbed=14,
        files={"a.fastq": 14},
        spill_runs=[run],
    )
    from kmer_counter.engine import CountEngine

    stats = CountEngine(opts).run()
    assert stats.reads == 24
    from kmer_counter.io.dump import load_table

    words, counts = load_table(str(tmp_path / "out.bin"), 15)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_checkpoint_missing_spill_run_ignored(tmp_path, rng):
    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file="x")
    words = records.pack_codes(np.zeros((1, 15), int), 15)
    run = tmp_path / "spill_000001.run"
    run.write_bytes(b"\x00" * 12)
    checkpoint.save(
        str(tmp_path / "ck"), opts, records.words_to_lanes(words),
        np.array([1], np.uint32), 3, spill_runs=[str(run)],
    )
    assert checkpoint.load(str(tmp_path / "ck"), opts) is not None
    run.unlink()  # the run vanished: the snapshot must be refused
    assert checkpoint.load(str(tmp_path / "ck"), opts) is None
