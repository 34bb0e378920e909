"""FASTQ ingest tests (io.fastq) against synthetic files."""

import numpy as np
import pytest

from kmer_counter.io.fastq import DirectoryInput, FASTQReader


def write_fastq(path, seqs, qual_char="I", header_extra=""):
    with open(path, "w") as fh:
        for i, seq in enumerate(seqs):
            fh.write(f"@read{i} {header_extra}\n{seq}\n+\n{qual_char * len(seq)}\n")


def random_seqs(rng, n, L, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), size=L)) for _ in range(n)]


def test_reader_basic(tmp_path, rng):
    seqs = random_seqs(rng, 25, 60)
    write_fastq(tmp_path / "a.fastq", seqs)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    assert reader.line_length == 60
    got = []
    while True:
        chunk = reader.read_chunk(10)
        if chunk is None:
            break
        assert chunk.line_length == 60
        got += [bytes(row).decode() for row in chunk.reads[: chunk.n_reads]]
    assert got == seqs


def test_reader_no_trailing_newline(tmp_path):
    data = "@r0\nACGTACGT\n+\nIIIIIIII\n@r1\nTTTTAAAA\n+\nIIIIIIII"
    (tmp_path / "a.fastq").write_text(data)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    chunk = reader.read_chunk(10)
    assert chunk.n_reads == 2
    assert bytes(chunk.reads[1]).decode() == "TTTTAAAA"


def test_reader_crlf(tmp_path):
    data = "@r0\r\nACGTACGT\r\n+\r\nIIIIIIII\r\n"
    (tmp_path / "a.fastq").write_text(data)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    chunk = reader.read_chunk(10)
    assert chunk.n_reads == 1
    # CR is stripped from the sequence; line_length from the first parse
    # includes it conservatively, and the row is zero-padded.
    assert bytes(chunk.reads[0]).rstrip(b"\x00").decode() == "ACGTACGT"


def test_reader_plus_quality_line(tmp_path):
    # A quality line starting with '+' must not confuse the parser (the
    # reference's next-line heuristic would, FASTQFileReader.cpp:57-74).
    data = "@r0\nACGTACGT\n+\n+IIIIIII\n@r1\nTTTTAAAA\n+\nIIIIIIII\n"
    (tmp_path / "a.fastq").write_text(data)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    chunk = reader.read_chunk(10)
    assert chunk.n_reads == 2
    assert bytes(chunk.reads[0]).decode() == "ACGTACGT"
    assert bytes(chunk.reads[1]).decode() == "TTTTAAAA"


def test_reader_not_fastq(tmp_path):
    (tmp_path / "bad.fastq").write_text("not a fastq\nfile\n")
    with pytest.raises(ValueError):
        FASTQReader(str(tmp_path / "bad.fastq"))


def test_reader_short_last_read(tmp_path):
    data = "@r0\nACGTACGTAC\n+\nIIIIIIIIII\n@r1\nACGT\n+\nIIII\n"
    (tmp_path / "a.fastq").write_text(data)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    chunk = reader.read_chunk(10)
    assert chunk.n_reads == 2
    assert bytes(chunk.reads[1]).decode() == "ACGT" + "\x00" * 6


def test_directory_input_multi_file(tmp_path, rng):
    seqs_a = random_seqs(rng, 12, 40)
    seqs_b = random_seqs(rng, 7, 40)
    write_fastq(tmp_path / "a.fastq", seqs_a)
    write_fastq(tmp_path / "b.fq", seqs_b)
    (tmp_path / "notes.md").write_text("ignore me")
    src = DirectoryInput(str(tmp_path))
    assert len(src.paths) == 2
    got = []
    while True:
        chunk = src.read_chunk(5)
        if chunk is None:
            break
        assert chunk.n_reads <= 5  # chunks never span files
        got += [bytes(row).decode() for row in chunk.reads[: chunk.n_reads]]
    assert got == seqs_a + seqs_b


def test_directory_input_empty(tmp_path):
    with pytest.raises(FileNotFoundError):
        DirectoryInput(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        DirectoryInput(str(tmp_path / "nope"))


def test_block_boundary_parsing(tmp_path, rng, monkeypatch):
    # Force tiny parse blocks so lines straddle block boundaries.
    import kmer_counter.io.fastq as fastq_mod

    monkeypatch.setattr(fastq_mod, "_BLOCK_BYTES", 7)
    seqs = random_seqs(rng, 10, 23)
    write_fastq(tmp_path / "a.fastq", seqs, header_extra="x" * 31)
    reader = FASTQReader(str(tmp_path / "a.fastq"))
    chunk = reader.read_chunk(100)
    assert chunk.n_reads == 10
    assert [bytes(r).decode() for r in chunk.reads] == seqs


def test_directory_input_skips_bad_files(tmp_path, rng, capsys):
    # A malformed file mid-run is skipped with a warning, not fatal
    # (reference behavior: print and continue, InputFileHandler.cpp:44-46).
    seqs_a = random_seqs(rng, 5, 30)
    seqs_c = random_seqs(rng, 4, 30)
    write_fastq(tmp_path / "a.fastq", seqs_a)
    (tmp_path / "b.fastq").write_text("this is not fastq\nat all\n")
    write_fastq(tmp_path / "c.fastq", seqs_c)
    src = DirectoryInput(str(tmp_path), use_native=False)
    got = []
    while True:
        chunk = src.read_chunk(100)
        if chunk is None:
            break
        got += [bytes(r).decode() for r in chunk.reads[: chunk.n_reads]]
    assert got == seqs_a + seqs_c
    assert len(src.probe_line_lengths()) == 2


def test_directory_input_bad_first_file(tmp_path, rng):
    (tmp_path / "a.fastq").write_text("garbage\n")
    seqs = random_seqs(rng, 3, 20)
    write_fastq(tmp_path / "b.fastq", seqs)
    src = DirectoryInput(str(tmp_path), use_native=False)
    chunk = src.read_chunk(10)
    assert [bytes(r).decode() for r in chunk.reads] == seqs


def test_byte_range_sharding_partitions_exactly(tmp_path, rng):
    # Adjacent byte ranges of one file partition its records exactly —
    # multi-host ingest over a single giant file.
    seqs = random_seqs(rng, 101, 37)
    write_fastq(tmp_path / "big.fastq", seqs, header_extra="hdr" * 5)
    got = []
    for i in range(3):
        src = DirectoryInput(str(tmp_path), shard=(i, 3), shard_mode="bytes")
        while True:
            chunk = src.read_chunk(17)
            if chunk is None:
                break
            got += [bytes(r).decode() for r in chunk.reads[: chunk.n_reads]]
    assert sorted(got) == sorted(seqs)
    assert got == seqs  # ranges are contiguous and ordered


def test_byte_range_handles_at_sign_quality(tmp_path):
    # Quality lines starting with '@' must not break record resync.
    from kmer_counter.io.fastq import FASTQReader

    seqs = ["ACGTACGTAC", "TTTTACGTAA", "GGGGACGTCC", "AAAACCCGGT"]
    data = "".join(f"@r{i}\n{s}\n+\n@@@@@@@@@@\n" for i, s in enumerate(seqs))
    (tmp_path / "a.fastq").write_text(data)
    size = len(data)
    got = []
    for i in range(2):
        r = FASTQReader(
            str(tmp_path / "a.fastq"),
            byte_range=(size * i // 2, size * (i + 1) // 2),
        )
        chunk = r.read_chunk(10)
        if chunk is not None:
            got += [bytes(x).decode() for x in chunk.reads[: chunk.n_reads]]
    assert got == seqs


# ---- ParallelIngest: the multi-threaded order-preserving reader pool ----


def _drain_chunks(src, max_reads):
    out = []
    while True:
        c = src.read_chunk(max_reads)
        if c is None:
            break
        out.append(c)
    src.close()
    return out


def _rows(chunks):
    return [
        bytes(r).rstrip(b"\x00").decode()
        for c in chunks
        for r in c.reads[: c.n_reads]
    ]


@pytest.mark.parametrize("threads", [2, 5])
def test_parallel_ingest_matches_sequential(tmp_path, rng, threads):
    from kmer_counter.io.fastq import ParallelIngest

    for i in range(5):
        write_fastq(tmp_path / f"f{i}.fastq", random_seqs(rng, 37 + i, 50))
    seq_chunks = _drain_chunks(DirectoryInput(str(tmp_path)), 16)
    par_chunks = _drain_chunks(
        ParallelIngest(str(tmp_path), threads=threads, unit_chunk_reads=8),
        16,
    )
    # identical read sequence (checkpoint-resume determinism)...
    assert _rows(par_chunks) == _rows(seq_chunks)
    # ...and no chunk spans files
    for c in par_chunks:
        assert len({c.path}) == 1


def test_parallel_ingest_segments_one_big_file(tmp_path, rng):
    # segment_bytes smaller than the file: several units per file, whose
    # re-assembled rows must equal the sequential parse exactly.
    from kmer_counter.io.fastq import ParallelIngest

    seqs = random_seqs(rng, 211, 44)
    write_fastq(tmp_path / "big.fastq", seqs)
    par = ParallelIngest(
        str(tmp_path), threads=3, segment_bytes=1024, unit_chunk_reads=16
    )
    assert len(par._units) > 1, "expected multiple byte-range units"
    got = _rows(_drain_chunks(par, 32))
    assert got == seqs


def test_parallel_ingest_mixed_line_lengths(tmp_path, rng):
    from kmer_counter.io.fastq import ParallelIngest

    write_fastq(tmp_path / "a.fastq", random_seqs(rng, 20, 30))
    write_fastq(tmp_path / "b.fastq", random_seqs(rng, 20, 70))
    par_chunks = _drain_chunks(
        ParallelIngest(str(tmp_path), threads=2, unit_chunk_reads=8), 64
    )
    seq_chunks = _drain_chunks(DirectoryInput(str(tmp_path)), 64)
    assert _rows(par_chunks) == _rows(seq_chunks)
    assert [c.line_length for c in par_chunks] == [
        c.line_length for c in seq_chunks
    ]


def test_parallel_ingest_skips_bad_file(tmp_path, rng, capsys):
    from kmer_counter.io.fastq import ParallelIngest

    write_fastq(tmp_path / "a.fastq", random_seqs(rng, 10, 40))
    (tmp_path / "b.fastq").write_text("this is not fastq\n")
    write_fastq(tmp_path / "c.fastq", random_seqs(rng, 10, 40))
    par = ParallelIngest(str(tmp_path), threads=2)
    got = _rows(_drain_chunks(par, 16))
    want = _rows(_drain_chunks(DirectoryInput(str(tmp_path)), 16))
    assert got == want
    assert len(got) == 20


def test_parallel_ingest_byte_shards_partition(tmp_path, rng):
    # multi-host byte-range sharding composed with in-host parallelism
    from kmer_counter.io.fastq import ParallelIngest

    seqs = random_seqs(rng, 97, 40)
    write_fastq(tmp_path / "one.fastq", seqs)
    got = []
    for idx in range(3):
        got += _rows(
            _drain_chunks(
                ParallelIngest(
                    str(tmp_path),
                    threads=2,
                    shard=(idx, 3),
                    shard_mode="bytes",
                    segment_bytes=2048,
                    unit_chunk_reads=8,
                ),
                16,
            )
        )
    assert got == seqs
