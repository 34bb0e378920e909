"""MeshCountEngine end-to-end on the virtual 8-device CPU mesh."""

import numpy as np

from kmer_counter.config import Options
from kmer_counter.engine import MeshCountEngine
from kmer_counter.io.dump import load_table

from test_engine import golden_dir_table
from test_ingest import random_seqs, write_fastq


def run_mesh_engine(tmp_path, k, canonical=False, **kw):
    out = str(tmp_path / "output.bin")
    opts = Options(
        kmer_length=k,
        canonical=canonical,
        input_dir=str(tmp_path / "in"),
        output_file=out,
        mesh_shape=(8,),
        verbose=0,
        **kw,
    )
    stats = MeshCountEngine(opts).run()
    return load_table(out, k), stats


def test_mesh_engine_matches_golden(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 100, 60))
    (words, counts), stats = run_mesh_engine(
        tmp_path, 31, canonical=True, reads_per_chunk=32
    )
    want_words, want_counts = golden_dir_table(tmp_path, 31, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 100


def test_mesh_engine_multi_file_mixed_lengths(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 30, 40))
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 20, 70))
    write_fastq(tmp_path / "in" / "c.fastq", random_seqs(rng, 5, 10))  # < k
    (words, counts), stats = run_mesh_engine(tmp_path, 15, reads_per_chunk=16)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 55


def test_mesh_engine_two_level_matches_golden(tmp_path, rng):
    """The two-level (keys-only raw + consolidate2) path on the mesh."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 120, 60))
    (words, counts), stats = run_mesh_engine(
        tmp_path, 31, canonical=True, reads_per_chunk=32, table_impl="two"
    )
    want_words, want_counts = golden_dir_table(tmp_path, 31, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 120


def test_mesh_engine_two_level_consolidates(tmp_path, rng):
    """Small raw region forces mid-run consolidations on every device."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 256, 40))
    (words, counts), stats = run_mesh_engine(
        tmp_path,
        15,
        reads_per_chunk=32,
        table_impl="two",
        table_slots=3000,  # per-mesh budget -> tiny per-device raw region
    )
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_mesh_engine_two_level_allt_side_count(tmp_path):
    """k=16 forward: all-T k-mers are bit-identical to the sentinel and
    must come back via the side counter as the final record."""
    (tmp_path / "in").mkdir()
    seqs = ["T" * 40, "T" * 40, ("ACGT" * 10)]
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    (words, counts), stats = run_mesh_engine(
        tmp_path, 16, canonical=False, reads_per_chunk=8, table_impl="two"
    )
    want_words, want_counts = golden_dir_table(tmp_path, 16, canonical=False)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    # the T^16 record is the maximum key: last row, count 2*(40-16+1)
    assert words[-1, 0] == np.uint64(0xFFFFFFFF00000000)
    assert counts[-1] == 2 * 25


def test_mesh_engine_skewed_keys_overflow_retry(tmp_path):
    """Adversarial skew: every k-mer shares one 16-bit prefix, so a single
    device owns the whole key space.  merge_slack=1/8 underprovisions the
    buckets; the finalize must retry with doubled capacity, not raise."""
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(7)
    # Reads starting with AAAAAAAA...: the leading 8 bases pin the 16-bit
    # prefix of every window that starts at position 0; to pin *all*
    # windows, make the whole read low-complexity: only A and C, so
    # lane0's top bits stay in a narrow band owned by device 0.
    chars = np.frombuffer(b"AC", dtype=np.uint8)
    reads = chars[rng.integers(0, 2, size=(96, 40))]
    seqs = ["".join(map(chr, r)) for r in reads]
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    for impl in ("one", "two"):
        (words, counts), stats = run_mesh_engine(
            tmp_path,
            15,
            reads_per_chunk=16,
            table_impl=impl,
            table_slots=3000,  # small buckets: cap ~6 vs ~150 skewed records
            merge_slack=0.125,
        )
        want_words, want_counts = golden_dir_table(tmp_path, 15)
        np.testing.assert_array_equal(words, want_words)
        np.testing.assert_array_equal(counts, want_counts)


def test_mesh_engine_spill_to_disk(tmp_path, rng):
    """Cardinality outgrows a tiny per-device budget: the engine spills
    consolidated shard runs to temp_dir and merges them into the output
    (the mesh form of BASELINE.json config 4)."""
    (tmp_path / "in").mkdir()
    (tmp_path / "tmp").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 512, 40))
    for impl in ("one", "two"):
        (words, counts), stats = run_mesh_engine(
            tmp_path,
            15,
            reads_per_chunk=64,
            table_impl=impl,
            table_slots=3000,
            temp_dir=str(tmp_path / "tmp"),
        )
        want_words, want_counts = golden_dir_table(tmp_path, 15)
        assert stats.spilled_runs > 0, f"spill path not exercised ({impl})"
        np.testing.assert_array_equal(words, want_words)
        np.testing.assert_array_equal(counts, want_counts)


import contextlib


@contextlib.contextmanager
def _spy_resumed(monkeypatch):
    """Record whether (and at which epoch) mesh_load actually resumed —
    a scratch recount also byte-matches golden, so the tests must observe
    the resume itself."""
    from kmer_counter import checkpoint as ckpt

    seen = {"epoch": -1}
    orig = ckpt.mesh_load

    def spy(*a, **kw):
        snap = orig(*a, **kw)
        if snap is not None:
            seen["epoch"] = snap.epoch
        return snap

    with monkeypatch.context() as mp:
        mp.setattr(ckpt, "mesh_load", spy)
        yield seen


def _crash_engine_after(monkeypatch, n_steps: int):
    """Make the counter's step raise after n_steps (simulated crash)."""
    from kmer_counter.parallel import pipeline as pl

    for cls in (pl.ShardedCounter, pl.ShardedCounter2):
        orig = cls.step
        state = {"n": 0}

        def step(self, reads, _orig=orig, _state=state):
            if _state["n"] >= n_steps:
                raise RuntimeError("simulated crash")
            _state["n"] += 1
            return _orig(self, reads)

        monkeypatch.setattr(cls, "step", step)


def test_mesh_engine_checkpoint_resume(tmp_path, rng, monkeypatch):
    """Single-process mesh checkpoint/resume (VERDICT r4 item 3): crash
    mid-run after checkpoints were taken, rerun, byte-match golden."""
    import pytest

    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 256, 60))
    ckpt = str(tmp_path / "ckpt")
    kw = dict(
        reads_per_chunk=32,
        table_slots=3000,
        checkpoint_dir=ckpt,
        checkpoint_every=1,
    )
    # The one-level mesh counter consolidates every 4 chunks at this
    # sizing (per-device slots floor 4x the chunk), so 6 steps guarantee
    # at least one consolidation + checkpoint before the crash.
    with monkeypatch.context() as mp:
        _crash_engine_after(mp, 6)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mesh_engine(tmp_path, 31, canonical=True, **kw)
    import os

    assert any(f.startswith("mesh.e") for f in os.listdir(ckpt))
    with _spy_resumed(monkeypatch) as resumed:
        (words, counts), stats = run_mesh_engine(
            tmp_path, 31, canonical=True, **kw
        )
    assert resumed["epoch"] >= 1, "second run did not resume the snapshot"
    want_words, want_counts = golden_dir_table(tmp_path, 31, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
    assert stats.reads == 256


def test_mesh_engine_checkpoint_resume_across_spill(tmp_path, rng, monkeypatch):
    """Mesh checkpoint/resume with disk spill active: the snapshot records
    the outstanding spill runs; resume re-registers them and the final
    hierarchical merge still byte-matches golden."""
    import pytest

    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 200, 60))
    ckpt = str(tmp_path / "ckpt")
    kw = dict(
        reads_per_chunk=32,
        table_slots=1200,
        temp_dir=str(tmp_path / "spill"),
        checkpoint_dir=ckpt,
        checkpoint_every=1,
        table_impl="two",
    )
    with monkeypatch.context() as mp:
        _crash_engine_after(mp, 5)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mesh_engine(tmp_path, 31, canonical=True, **kw)
    import os

    assert any(
        f.endswith(".run") for f in os.listdir(tmp_path / "spill")
    ), "the crashed run never spilled — the test sizing regressed"
    with _spy_resumed(monkeypatch) as resumed:
        (words, counts), stats = run_mesh_engine(
            tmp_path, 31, canonical=True, **kw
        )
    assert resumed["epoch"] >= 1, "second run did not resume the snapshot"
    want_words, want_counts = golden_dir_table(tmp_path, 31, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_mesh_engine_checkpoint_ignored_on_config_change(tmp_path, rng):
    """A mesh snapshot taken at a different k must be ignored (fresh
    count), not half-resumed."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 60, 60))
    ckpt = str(tmp_path / "ckpt")
    kw = dict(reads_per_chunk=16, checkpoint_dir=ckpt, checkpoint_every=1,
              table_slots=1500)
    run_mesh_engine(tmp_path, 31, canonical=True, **kw)
    (words, counts), _ = run_mesh_engine(tmp_path, 15, **kw)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
