"""Randomized differential testing: device pipeline vs the golden model.

Each case draws k, canonical, read length, read count, invalid-base rate
and duplication level from a seeded RNG and requires exact count-table
equality — the property the whole framework must uphold.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from kmer_counter import golden
from kmer_counter.ops import count_chunk
from kmer_counter.utils.seqgen import random_genome, sample_reads

from test_ops import table_to_counter


@pytest.mark.parametrize("seed", range(12))
def test_pipeline_matches_golden_fuzzed(seed):
    rng = np.random.default_rng(1000 + seed)
    k = int(rng.integers(2, 65))
    L = int(k + rng.integers(1, 40))
    R = int(rng.integers(1, 24))
    canonical = bool(rng.integers(0, 2))
    invalid = float(rng.choice([0.0, 0.02, 0.15]))
    genome = random_genome(rng, int(rng.integers(L, 4 * L * R + L)))
    reads = sample_reads(rng, genome, R, L, invalid_frac=invalid)
    lanes, counts, n = count_chunk(jnp.asarray(reads), k, canonical)
    got = table_to_counter(lanes, counts, n, k)
    want = dict(golden.count_reads(reads, k, canonical))
    assert got == want, f"seed={seed} k={k} L={L} R={R} canonical={canonical}"


@pytest.mark.parametrize("seed", range(4))
def test_sharded_matches_golden_fuzzed(seed):
    import jax

    from kmer_counter.parallel.mesh import make_mesh
    from kmer_counter.parallel.pipeline import ShardedCounter
    from test_parallel import table_as_counter

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    rng = np.random.default_rng(2000 + seed)
    k = int(rng.integers(3, 40))
    L = int(k + rng.integers(4, 30))
    canonical = bool(rng.integers(0, 2))
    genome = random_genome(rng, 500)
    counter = ShardedCounter(
        mesh, k, canonical, table_slots=4096, reads_per_device=3, line_length=L
    )
    want = {}
    for _ in range(int(rng.integers(1, 4))):
        reads = sample_reads(rng, genome, 24, L, invalid_frac=0.03)
        for key, c in golden.count_reads(reads, k, canonical).items():
            want[key] = want.get(key, 0) + c
        counter.step(reads)
    lanes, counts = counter.finalize()
    assert table_as_counter(lanes, counts, k) == want, f"seed={seed} k={k}"


@pytest.mark.parametrize("seed", range(6))
def test_parallel_ingest_matches_sequential_fuzzed(tmp_path, seed):
    """ParallelIngest must reproduce DirectoryInput's exact read sequence
    for random file layouts: varying file counts/sizes, thread counts,
    byte-segment sizes, chunk sizes, missing trailing newlines."""
    from kmer_counter.io.fastq import DirectoryInput, ParallelIngest

    rng = np.random.default_rng(3000 + seed)
    n_files = int(rng.integers(1, 6))
    L = int(rng.integers(10, 80))
    for f in range(n_files):
        n = int(rng.integers(1, 120))
        lines = []
        for i in range(n):
            seq = "".join(rng.choice(list("ACGTN"), size=L))
            q = rng.choice(["I" * L, "@" + "I" * (L - 1), "+" + "I" * (L - 1)])
            lines.append(f"@r{i} x\n{seq}\n+\n{q}")
        data = "\n".join(lines)
        if rng.integers(0, 2):
            data += "\n"
        (tmp_path / f"f{f}.fastq").write_text(data)

    def rows(src, max_reads):
        out = []
        while True:
            c = src.read_chunk(max_reads)
            if c is None:
                break
            out += [
                bytes(r).rstrip(b"\x00").decode()
                for r in c.reads[: c.n_reads]
            ]
        src.close()
        return out

    max_reads = int(rng.integers(1, 40))
    want = rows(DirectoryInput(str(tmp_path)), max_reads)
    got = rows(
        ParallelIngest(
            str(tmp_path),
            threads=int(rng.integers(1, 5)),
            segment_bytes=int(rng.integers(256, 4096)),
            unit_chunk_reads=int(rng.integers(1, 32)),
        ),
        max_reads,
    )
    assert got == want, f"seed={seed} files={n_files} L={L}"


# ---------------------------------------------------------------------------
# Malformed-FASTQ loud-failure cases: both parsers track record phase by
# line counting, so a missing/extra/truncated line must raise instead of
# silently shifting sequence/quality assignment (VERDICT r4 item 8).


def _corrupt(text: str, mode: str) -> str:
    lines = text.split("\n")
    if mode == "drop_quality":  # quality of record 1 vanishes
        del lines[7]
    elif mode == "drop_separator":  # '+' of record 1 vanishes
        del lines[6]
    elif mode == "truncate_mid_record":  # file ends after a sequence line
        lines = lines[:6]
    elif mode == "blank_line":  # stray empty line between records
        lines.insert(4, "")
    else:
        raise AssertionError(mode)
    return "\n".join(lines)


@pytest.mark.parametrize(
    "mode", ["drop_quality", "drop_separator", "truncate_mid_record", "blank_line"]
)
@pytest.mark.parametrize("parser", ["python", "native"])
def test_malformed_fastq_fails_loudly(tmp_path, mode, parser):
    from kmer_counter.io import native
    from kmer_counter.io.fastq import FASTQReader

    if parser == "native" and not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(7)
    L = 30
    text = ""
    for i in range(4):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        text += f"@r{i} x\n{seq}\n+\n{'I' * L}\n"
    path = tmp_path / "bad.fastq"
    path.write_text(_corrupt(text, mode))

    def drain(reader):
        while reader.read_chunk(8) is not None:
            pass

    opener = (
        FASTQReader if parser == "python" else native.NativeFASTQReader
    )
    with pytest.raises(ValueError):
        drain(opener(str(path)))


@pytest.mark.parametrize("parser", ["python", "native"])
def test_wellformed_fastq_still_parses(tmp_path, parser):
    """The validation must not reject legal files: '@'/'+'-leading quality
    lines, missing trailing newline, CRLF endings."""
    from kmer_counter.io import native
    from kmer_counter.io.fastq import FASTQReader

    if parser == "native" and not native.available():
        pytest.skip("native library not built")
    L = 12
    recs = [
        ("@r0 a", "ACGTACGTACGT", "+", "@" + "I" * (L - 1)),
        ("@r1 b", "TTTTACGTACGT", "+r1", "+" + "I" * (L - 1)),
        ("@r2 c", "ACGTACGTACGA", "+", "I" * L),
    ]
    text = "\n".join("\n".join(r) for r in recs)  # no trailing newline
    path = tmp_path / "ok.fastq"
    path.write_text(text)
    opener = FASTQReader if parser == "python" else native.NativeFASTQReader
    reader = opener(str(path))
    got = []
    while True:
        c = reader.read_chunk(8)
        if c is None:
            break
        got += [bytes(r).decode() for r in c.reads[: c.n_reads]]
    assert got == [r[1] for r in recs]
