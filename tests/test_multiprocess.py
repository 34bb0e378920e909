"""Real multi-process mesh run: 2 jax.distributed CPU processes.

Spawns two subprocesses that form one 8-device mesh (4 virtual CPU
devices each) and run MeshCountEngine end-to-end; the per-range ``.part``
files they dump are concatenated in name order and byte-compared against
the golden model.  This executes the process_count()>1 branches no
in-process test can reach: the lockstep chunk allgather, the per-process
block assembly of the sharded reads array, the cross-process all_to_all
merge, and the finalize_local part/manifest protocol.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from test_engine import golden_dir_table
from test_ingest import random_seqs, write_fastq

_WORKER = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(
    tmp_path,
    impl: str,
    k: int,
    table_slots: int = 0,
    temp_dir: str = "",
    ckpt_dir: str = "",
    checkpoint_every: int = 0,
    crash_after: int = 0,
):
    out = str(tmp_path / f"out_{impl}.bin")
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the worker forces cpu itself
    env.pop("XLA_FLAGS", None)  # conftest's 8-device flag; worker sets 4
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(_WORKER))
    if crash_after:
        env["KMER_TEST_CRASH_AFTER_CHUNKS"] = str(crash_after)
    argv = [
        sys.executable,
        _WORKER,
        "PID",
        "2",
        str(port),
        str(tmp_path / "in"),
        out,
        impl,
        str(k),
        str(table_slots),
    ]
    if temp_dir or ckpt_dir:
        argv.append(temp_dir)
    if ckpt_dir:
        argv += [ckpt_dir, str(checkpoint_every)]
    procs = [
        subprocess.Popen(
            [a if a != "PID" else str(pid) for a in argv],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"multi-process worker timed out; partial: {logs}")
        logs.append(stdout)
        if crash_after:
            assert p.returncode == 17, f"expected simulated crash:\n{stdout}"
        else:
            assert p.returncode == 0, f"worker failed:\n{stdout}"
    if crash_after:
        return None, logs
    # Assemble: parts in name order are the globally sorted table.
    parts = sorted(
        str(tmp_path / f) for f in os.listdir(tmp_path) if f.startswith(
            os.path.basename(out) + ".part"
        )
    )
    assert parts, f"no part files dumped; logs: {logs}"
    data = b"".join(open(p, "rb").read() for p in parts)
    merged = str(tmp_path / f"merged_{impl}.bin")
    with open(merged, "wb") as fh:
        fh.write(data)
    manifests = [
        f for f in os.listdir(tmp_path) if ".manifest." in f
    ]
    assert len(manifests) == 2, manifests
    return merged, logs


@pytest.mark.parametrize("impl", ["one", "two"])
def test_two_process_mesh_matches_golden(tmp_path, impl):
    rng = np.random.default_rng(3)
    (tmp_path / "in").mkdir()
    # 4 files so the round-robin file shard gives both processes data.
    for i in range(4):
        write_fastq(
            tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, 40, 60)
        )
    k = 31
    merged, _logs = _run_workers(tmp_path, impl, k)
    from kmer_counter.io.dump import load_table

    words, counts = load_table(merged, k)
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_two_process_mesh_grow_under_pressure(tmp_path):
    """Tiny per-device table: cardinality forces device-side prefix
    growth (ShardedCounter2._grow_prefix) across BOTH processes in
    lockstep — the growth path that is impossible to exercise on a
    single-process mesh honestly."""
    rng = np.random.default_rng(9)
    (tmp_path / "in").mkdir()
    for i in range(4):
        write_fastq(
            tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, 48, 60)
        )
    k = 31
    merged, _logs = _run_workers(tmp_path, "two", k, table_slots=4000)
    from kmer_counter.io.dump import load_table

    words, counts = load_table(merged, k)
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_two_process_mesh_spill_matches_golden(tmp_path):
    """Tiny per-device HBM budget + a temp dir: mid-run disk spill on a
    multi-process mesh (the round-3 MemoryError corner).  Records are
    routed to their range owners, each process spills per-position runs,
    and the final parts are host-merged per range — the concatenated
    output must still byte-match golden."""
    rng = np.random.default_rng(11)
    (tmp_path / "in").mkdir()
    for i in range(4):
        write_fastq(
            tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, 64, 60)
        )
    k = 31
    merged, logs = _run_workers(
        tmp_path, "two", k, table_slots=1200,
        temp_dir=str(tmp_path / "tmp_spill"),
    )
    assert any("spilled=" in l and "spilled=0" not in l.split()[-1] for l in logs), (
        f"no spill happened; workers: {logs}"
    )
    from kmer_counter.io.dump import load_table

    words, counts = load_table(merged, k)
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("impl", ["one", "two"])
def test_two_process_kill_resume_matches_golden(tmp_path, impl):
    """VERDICT r4 item 3 — mesh checkpoint/resume: both processes die
    mid-run (after the same step count, so the collectives stay lockstep),
    then a rerun resumes from the newest complete checkpoint epoch and the
    final output still byte-matches golden."""
    rng = np.random.default_rng(21)
    (tmp_path / "in").mkdir()
    for i in range(4):
        write_fastq(
            tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, 48, 60)
        )
    k = 31
    ckpt = str(tmp_path / "ckpt")
    # Small table => consolidation (and a checkpoint) every chunk; crash
    # after 4 steps so at least one complete epoch exists.
    _, logs = _run_workers(
        tmp_path, impl, k, table_slots=4000,
        ckpt_dir=ckpt, checkpoint_every=1, crash_after=4,
    )
    assert any("simulated crash" in l for l in logs), logs
    assert os.path.isdir(ckpt) and any(
        f.startswith("mesh.e") and f.endswith(".json") for f in os.listdir(ckpt)
    ), f"no checkpoint written before the crash: {os.listdir(tmp_path)}"
    merged, logs2 = _run_workers(
        tmp_path, impl, k, table_slots=4000,
        ckpt_dir=ckpt, checkpoint_every=1,
    )
    assert all("resumed mesh checkpoint" in l for l in logs2), logs2
    from kmer_counter.io.dump import load_table

    words, counts = load_table(merged, k)
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_two_process_kill_resume_across_spill(tmp_path):
    """Mesh checkpoint/resume with multi-process disk spill active: the
    per-position spill runs recorded in the snapshot must be restored
    (pos_runs + sequence renumber past existing files) and the final
    range-merged parts still byte-match golden."""
    rng = np.random.default_rng(23)
    (tmp_path / "in").mkdir()
    for i in range(4):
        write_fastq(
            tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, 64, 60)
        )
    k = 31
    ckpt = str(tmp_path / "ckpt")
    spill = str(tmp_path / "tmp_spill")
    # Tiny budget: spill engages early; checkpoint every consolidation;
    # crash after 6 steps (spill + at least one post-spill checkpoint).
    _, logs = _run_workers(
        tmp_path, "two", k, table_slots=1200, temp_dir=spill,
        ckpt_dir=ckpt, checkpoint_every=1, crash_after=6,
    )
    assert any("simulated crash" in l for l in logs), logs
    assert os.path.isdir(spill) and any(
        f.endswith(".run") for f in os.listdir(spill)
    ), "test sizing regressed: no spill before the crash"
    # The snapshot must actually carry the spill state: at least one
    # committed manifest with a non-empty pos_runs (otherwise this test
    # would pass without exercising the restore path).
    import json

    manifests = [
        json.load(open(os.path.join(ckpt, f)))
        for f in os.listdir(ckpt)
        if f.startswith("mesh.e") and f.endswith(".json")
    ]
    assert any(m.get("pos_runs") for m in manifests), (
        "no post-spill checkpoint was taken before the crash — "
        f"tune crash_after; manifests: {[sorted(m) for m in manifests]}"
    )
    merged, logs2 = _run_workers(
        tmp_path, "two", k, table_slots=1200, temp_dir=spill,
        ckpt_dir=ckpt, checkpoint_every=1,
    )
    assert all("resumed mesh checkpoint" in l for l in logs2), logs2
    from kmer_counter.io.dump import load_table

    words, counts = load_table(merged, k)
    want_words, want_counts = golden_dir_table(tmp_path, k, canonical=True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
