"""Native C++ runtime tests: parity with the Python FASTQ parser / merger.

Skipped when native/libkmer_io.so has not been built (make -C native).
"""

import numpy as np
import pytest

from kmer_counter import golden, records
from kmer_counter.io import native
from kmer_counter.io.fastq import DirectoryInput, FASTQReader
from kmer_counter.io.spill import merge_runs, write_run

from test_ingest import random_seqs, write_fastq
from test_spill import make_run, read_all

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_native_reader_matches_python(tmp_path, rng):
    seqs = random_seqs(rng, 33, 61)
    write_fastq(tmp_path / "a.fastq", seqs)
    py = FASTQReader(str(tmp_path / "a.fastq"))
    nat = native.NativeFASTQReader(str(tmp_path / "a.fastq"))
    assert nat.line_length == py.line_length
    while True:
        pc = py.read_chunk(7)
        nc = nat.read_chunk(7)
        if pc is None:
            assert nc is None
            break
        assert nc.n_reads == pc.n_reads
        np.testing.assert_array_equal(nc.reads, pc.reads[: pc.n_reads])


def test_native_reader_edge_cases(tmp_path):
    # no trailing newline + CRLF + short last read + '+'-leading quality
    data = (
        "@r0\r\nACGTACGTAC\r\n+\r\n+IIIIIIIII\r\n"
        "@r1\nACGT\n+\nIIII\n"
        "@r2\nTTTTAAAACC\n+\nIIIIIIIIII"
    )
    (tmp_path / "a.fastq").write_bytes(data.encode())
    nat = native.NativeFASTQReader(str(tmp_path / "a.fastq"))
    chunk = nat.read_chunk(10)
    assert chunk.n_reads == 3
    assert bytes(chunk.reads[0]).decode() == "ACGTACGTAC"
    assert bytes(chunk.reads[1]).decode() == "ACGT" + "\x00" * 6
    assert bytes(chunk.reads[2]).decode() == "TTTTAAAACC"


def test_native_reader_rejects_non_fastq(tmp_path):
    (tmp_path / "bad.fastq").write_text("garbage\nstuff\n")
    with pytest.raises(ValueError):
        native.NativeFASTQReader(str(tmp_path / "bad.fastq"))


def test_directory_input_uses_native(tmp_path, rng):
    write_fastq(tmp_path / "a.fastq", random_seqs(rng, 5, 30))
    src = DirectoryInput(str(tmp_path))
    assert type(src._reader).__name__ == "NativeFASTQReader"
    src_py = DirectoryInput(str(tmp_path), use_native=False)
    assert type(src_py._reader).__name__ == "FASTQReader"
    a = src.read_chunk(10)
    b = src_py.read_chunk(10)
    np.testing.assert_array_equal(a.reads[: a.n_reads], b.reads[: b.n_reads])


def test_native_merge_matches_python(tmp_path, rng):
    k = 15
    c1 = golden.count_reads(
        ["".join(rng.choice(list("ACGT"), 50)) for _ in range(10)], k
    )
    c2 = golden.count_reads(
        ["".join(rng.choice(list("ACGT"), 50)) for _ in range(10)], k
    )
    shared = list(c1)[3]
    c2[shared] = c2.get(shared, 0) + 5
    p1 = make_run(tmp_path, "a.run", c1, k)
    p2 = make_run(tmp_path, "b.run", c2, k)
    out_nat = str(tmp_path / "nat.bin")
    out_py = str(tmp_path / "py.bin")
    n_nat = merge_runs([p1, p2], out_nat, k)  # auto-dispatches native
    n_py = merge_runs([p1, p2], out_py, k, use_native=False)
    assert n_nat == n_py
    assert read_all(out_nat, k) == read_all(out_py, k)
    assert open(out_nat, "rb").read() == open(out_py, "rb").read()


def test_native_merge_multiword_keys(tmp_path, rng):
    k = 55
    c1 = golden.count_reads(
        ["".join(rng.choice(list("ACGT"), 80)) for _ in range(5)], k
    )
    p1 = make_run(tmp_path, "a.run", c1, k)
    out = str(tmp_path / "m.bin")
    n = merge_runs([p1, p1], out, k)
    got = read_all(out, k)
    assert n == len(c1)
    assert got == {key: 2 * v for key, v in c1.items()}


def test_native_byte_range_partitions_exactly(tmp_path, rng):
    # kc_open_range: adjacent ranges partition a file with adversarial
    # '@'/'+'-leading quality lines, byte-identically to the Python
    # byte-range parser (io.fastq.FASTQReader._seek_to_record twin).
    seqs = random_seqs(rng, 101, 48)
    path = tmp_path / "a.fastq"
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            q = ("@" if i % 7 == 0 else "+" if i % 5 == 0 else "I") * 48
            fh.write(f"@r{i}\n{s}\n+\n{q}\n")
    import os

    size = os.path.getsize(path)
    for count in (2, 4):
        got = []
        for idx in range(count):
            br = (size * idx // count, size * (idx + 1) // count)
            r = native.NativeFASTQReader(str(path), byte_range=br)
            while True:
                c = r.read_chunk(16)
                if c is None:
                    break
                got += [
                    bytes(row).rstrip(b"\x00").decode()
                    for row in c.reads[: c.n_reads]
                ]
            r.close()
        assert got == seqs, f"shard count {count}"


def test_directory_input_byte_shard_uses_native(tmp_path, rng):
    # shard_mode="bytes" must keep the native fast path (round-3 VERDICT:
    # it silently fell back to the Python parser).
    seqs = random_seqs(rng, 50, 40)
    write_fastq(tmp_path / "a.fastq", seqs)
    got = []
    for idx in range(2):
        src = DirectoryInput(str(tmp_path), shard=(idx, 2), shard_mode="bytes")
        assert isinstance(src._reader, native.NativeFASTQReader), (
            "byte-range shard lost the native parser"
        )
        while True:
            c = src.read_chunk(16)
            if c is None:
                break
            got += [
                bytes(r).rstrip(b"\x00").decode() for r in c.reads[: c.n_reads]
            ]
        src.close()
    assert sorted(got) == sorted(seqs)
