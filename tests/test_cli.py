"""CLI end-to-end tests: count mode and print mode (main.cpp parity)."""

import io
import subprocess
import sys

import numpy as np

from kmer_counter import golden, records
from kmer_counter.__main__ import main as cli_main
from kmer_counter.io.dump import load_table
from kmer_counter.io.printer import print_records

from test_engine import golden_dir_table
from test_ingest import random_seqs, write_fastq


def test_cli_count_mode(tmp_path, rng, capsys, monkeypatch):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 12, 40))
    out = tmp_path / "output.bin"
    rc = cli_main(
        [
            "kmerLength=15",
            f"inputFileLocation={tmp_path / 'in'}",
            f"outputFile={out}",
            "readsPerChunk=4",
            "verbose=0",
        ]
    )
    assert rc == 0
    captured = capsys.readouterr()
    assert "Updating kmerLength=15" in captured.out
    words, counts = load_table(str(out), 15)
    want_words, want_counts = golden_dir_table(tmp_path, 15)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_cli_missing_required_flags(capsys):
    rc = cli_main(["kmerLength=15"])
    assert rc == 2
    assert "required flag" in capsys.readouterr().err


def test_cli_print_mode(tmp_path, capsys):
    # Build a tiny record file by hand, then print it.
    counter = golden.count_reads(["ACGTACGTA"], k=4)
    (tmp_path / "t.bin").write_bytes(golden.serialize_counter(counter))
    rc = cli_main(["print", str(tmp_path / "t.bin"), "-", "4"])
    assert rc == 0
    out_lines = [
        line
        for line in capsys.readouterr().out.splitlines()
        if line and not line.startswith("###")
    ]
    # Reference format: 32 bases per word (padding as 'A') + space + count.
    assert len(out_lines) == len(counter)
    for line in out_lines:
        kmer, count = line.rsplit(" ", 1)
        assert len(kmer) == 32
        assert set(kmer) <= set("ACGT")
        assert count.isdigit()
    # ACGT appears twice in ACGTACGTA
    acgt_line = [l for l in out_lines if l.startswith("ACGT" + "A" * 28)]
    assert acgt_line and acgt_line[0].endswith(" 2")


def test_cli_print_to_file(tmp_path):
    counter = golden.count_reads(["ACGTACGTA"], k=4)
    (tmp_path / "t.bin").write_bytes(golden.serialize_counter(counter))
    out_file = tmp_path / "rendered.txt"
    rc = cli_main(["print", str(tmp_path / "t.bin"), str(out_file), "4"])
    assert rc == 0
    assert len(out_file.read_text().splitlines()) == len(counter)


def test_print_records_trim(tmp_path):
    counter = golden.count_reads(["ACGTACGTA"], k=4)
    path = tmp_path / "t.bin"
    path.write_bytes(golden.serialize_counter(counter))
    buf = io.StringIO()
    n = print_records(str(path), 4, out=buf, trim=True)
    assert n == len(counter)
    for line in buf.getvalue().splitlines():
        kmer, _ = line.rsplit(" ", 1)
        assert len(kmer) == 4


def test_cli_as_module(tmp_path, rng):
    """Smoke-test `python -m kmer_counter` as a real subprocess."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 6, 30))
    out = tmp_path / "output.bin"
    env = {
        "PATH": "/usr/bin:/bin",
        "JAX_PLATFORMS": "cpu",
        "HOME": "/root",
    }
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "kmer_counter",
            "kmerLength=9",
            f"inputFileLocation={tmp_path / 'in'}",
            f"outputFile={out}",
            "verbose=0",
        ],
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    words, counts = load_table(str(out), 9)
    want_words, want_counts = golden_dir_table(tmp_path, 9)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)


def test_print_records_chunk_boundary(tmp_path):
    # More records than the 10,000-record streaming chunk
    # (KMerPrinter.cpp:26) must render completely.
    import numpy as np

    from kmer_counter import records as rec

    U = 25_000
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(U, 8)).astype(np.uint8)
    words = np.unique(rec.pack_codes(codes, 8), axis=0)
    counts = np.arange(1, len(words) + 1, dtype=np.uint32)
    (tmp_path / "t.bin").write_bytes(rec.serialize_table(words, counts))
    out_file = tmp_path / "r.txt"
    with open(out_file, "w") as fh:
        n = print_records(str(tmp_path / "t.bin"), 8, out=fh)
    lines = out_file.read_text().splitlines()
    assert n == len(words) == len(lines)
    assert lines[-1].endswith(f" {counts[-1]}")


def test_unknown_flag_warns_but_is_ignored(capsys):
    """Reference parity: unknown flags are ignored (main.cpp ignores
    anything it doesn't strncmp-match) — but we print one stderr warning
    so a typo'd flag can't silently change semantics (VERDICT r4 item 8)."""
    from kmer_counter.config import Options

    opts = Options.from_argv(["kmerLength=21", "canonicl=true", "bogus=1"])
    assert opts.kmer_length == 21
    assert opts.canonical is False  # the typo did NOT flip semantics
    err = capsys.readouterr().err
    assert "canonicl" in err and "bogus" in err
    assert "unknown flag" in err
