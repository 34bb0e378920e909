"""CLI entry point — drop-in parity with the reference's main.cpp.

Count mode (main.cpp:84-87):
    python -m kmer_counter kmerLength=31 inputFileLocation=DIR \\
        outputFile=out.bin [gpuMemoryLimit=N] [canonical=true] ...

Print mode (main.cpp:78-82):
    python -m kmer_counter print <input.bin> <output(unused)> <kmerLength>

The print-mode argv shape (4 positionals, the 3rd accepted and ignored when
'-' ) matches the reference, whose output filename is accepted but never
used (KMerPrinter.cpp:13-16,35); pass a real path to actually write there.
"""

from __future__ import annotations

import sys

from kmer_counter.config import Options


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print("### kmer-counter ###")

    if len(argv) == 4 and argv[0] == "print":
        from kmer_counter.io.printer import print_records

        _, input_path, output_path, k = argv
        try:
            k_int = int(k)
            if output_path not in ("-", ""):
                with open(output_path, "w") as fh:
                    print_records(input_path, k_int, out=fh)
            else:
                print_records(input_path, k_int)
        except FileNotFoundError:
            print(f"error: no such record file: {input_path}", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    opts = Options.from_argv(argv)
    for flag, (attr, _) in Options._FLAGS.items():
        value = getattr(opts, attr)
        if any(a.startswith(flag + "=") for a in argv):
            print(f"Updating {flag}={value}")
    missing = [
        name
        for name, value in (
            ("inputFileLocation", opts.input_dir),
            ("outputFile", opts.output_file),
        )
        if not value
    ]
    if missing:
        print(f"error: required flag(s) not set: {', '.join(missing)}", file=sys.stderr)
        return 2

    import jax

    from kmer_counter.engine import run_count
    from kmer_counter.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    print(
        f"devices: platform={devices[0].platform} "
        f"kind={devices[0].device_kind} count={len(devices)}"
    )
    stats = run_count(opts)
    return 0 if stats.chunks >= 0 else 1


if __name__ == "__main__":
    sys.exit(main())
