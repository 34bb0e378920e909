"""Configuration — the analog of the reference's Options bag.

Accepts the same ``key=value`` CLI flags as the reference parser
(main.cpp:32-67): ``kmerLength``, ``gpuMemoryLimit``, ``inputFileLocation``,
``tempFileLocation``, ``outputFile``, ``noOfMergersAtOnce``,
``noOfMergeThreads`` — plus extensions.  Unlike the reference we
do not default to hardcoded personal paths (main.cpp:27-30, a documented
defect, SURVEY.md §7.1); required paths must be given.

``gpuMemoryLimit`` keeps its reference name for drop-in CLI parity but maps
to the per-device working-set budget that sizes the per-step read chunk —
the role GetChunkSize gives it in the reference (KMerCounter.cpp:193-212).
"""

from __future__ import annotations

import dataclasses


def _parse_mesh(s: str) -> tuple[int, ...]:
    """'8' or '2x4' → (8,) / (2, 4)."""
    dims = tuple(int(p) for p in s.lower().replace("*", "x").split("x"))
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad mesh shape: {s!r}")
    return dims


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


@dataclasses.dataclass
class Options:
    """Engine configuration (reference Options.h:21-57 + extensions)."""

    # --- reference flags (names kept for CLI parity; defaults from
    # Options.cpp:16-22 where sane: k=32, 2 mergers x 2 threads; memory
    # default follows main.cpp:28's 100 MB rather than the ctor's 10 MB,
    # which plans small chunks: on a GPU pass a gpuMemoryLimit sized to
    # the card (chip_smoke.py uses 8000000000 on an 80 GB H100). ---
    kmer_length: int = 32
    memory_limit_bytes: int = 100_000_000  # per-device working-set budget
    input_dir: str | None = None
    temp_dir: str | None = None
    output_file: str | None = None
    no_of_mergers_at_once: int = 2  # host spill-merge fan-in (io.spill)
    no_of_merge_threads: int = 2  # host spill-merge parallelism

    # --- extensions ---
    canonical: bool = False  # min(kmer, revcomp) keys; False == reference
    mesh_shape: tuple[int, ...] | None = None  # None => all local devices
    merge_slack: float = 4.0  # all_to_all bucket headroom vs key-space skew
    reads_per_chunk: int | None = None  # override auto chunk sizing
    table_slots: int | None = None  # override HBM accumulator capacity
    prefetch_chunks: int = 2  # host ingest pipeline depth (8-stream analog)
    # Parser threads feeding the ingest queue (order-preserving; see
    # io.fastq.ParallelIngest — the reference's 8-stream reader overlap,
    # KMerCounter.cpp:117-147).  1 = the single sequential reader.
    ingest_threads: int = 4
    checkpoint_every: int = 0  # consolidations between snapshots; 0 = off
    checkpoint_dir: str | None = None
    profile: bool = False
    verbose: int = 1
    # "two" = two-level table (ops.table2, consolidate2 merges); "one" =
    # single-buffer sort_reduce table (ops.table); "auto" = the one
    # engine.AUTO_TABLE_IMPL names, the same on every platform.
    table_impl: str = "auto"

    def __post_init__(self):
        if not 1 <= self.kmer_length <= 128:
            raise ValueError(f"kmerLength must be in [1,128], got {self.kmer_length}")
        if self.memory_limit_bytes <= 0:
            raise ValueError("gpuMemoryLimit must be positive")

    # Mapping: CLI flag name -> (attribute, parser). Reference flag names
    # are verbatim from main.cpp:32-67.
    _FLAGS = {
        "kmerLength": ("kmer_length", int),
        "gpuMemoryLimit": ("memory_limit_bytes", int),
        "inputFileLocation": ("input_dir", str),
        "tempFileLocation": ("temp_dir", str),
        "outputFile": ("output_file", str),
        "noOfMergersAtOnce": ("no_of_mergers_at_once", int),
        "noOfMergeThreads": ("no_of_merge_threads", int),
        # extensions
        "canonical": ("canonical", _parse_bool),
        "meshShape": ("mesh_shape", _parse_mesh),
        "mergeSlack": ("merge_slack", float),
        "readsPerChunk": ("reads_per_chunk", int),
        "tableSlots": ("table_slots", int),
        "prefetchChunks": ("prefetch_chunks", int),
        "ingestThreads": ("ingest_threads", int),
        "checkpointEvery": ("checkpoint_every", int),
        "checkpointDir": ("checkpoint_dir", str),
        "profile": ("profile", _parse_bool),
        "verbose": ("verbose", int),
        "tableImpl": ("table_impl", str),
    }

    @classmethod
    def from_argv(cls, argv: list[str]) -> "Options":
        """Parse reference-style ``key=value`` args (main.cpp:32-67).

        Unknown args are ignored for reference parity (main.cpp does the
        same), but each one gets a stderr warning so a typo'd flag (e.g.
        ``canonicl=true``) cannot silently change semantics.
        """
        import sys

        opts = cls()
        for arg in argv:
            if "=" not in arg:
                continue
            key, _, value = arg.partition("=")
            spec = cls._FLAGS.get(key)
            if spec is None:
                print(
                    f"warning: ignoring unknown flag {key!r}"
                    f" (known: {', '.join(sorted(cls._FLAGS))})",
                    file=sys.stderr,
                )
                continue
            attr, parse = spec
            setattr(opts, attr, parse(value))
        opts.__post_init__()
        return opts

    @property
    def words_per_kmer(self) -> int:
        return -(-self.kmer_length // 32)

    @property
    def lanes_per_kmer(self) -> int:
        return 2 * self.words_per_kmer
