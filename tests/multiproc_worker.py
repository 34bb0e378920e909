"""Worker for the multi-process mesh test: one jax.distributed process.

Launched by tests/test_multiprocess.py as ``python multiproc_worker.py
<pid> <nproc> <port> <input_dir> <output_file> <table_impl> <k>``.  Each
process owns 4 virtual CPU devices; the two processes form one 8-device
``data`` mesh, so the engine's multi-process branches — lockstep chunk
allgather (engine.py), make_array_from_process_local_data and the
cross-process all_to_all finalize (parallel.pipeline), per-part dumps
(finalize_local) — all execute for real (SURVEY.md §4's multi-host test
mandate; the reference has no multi-node story at all).
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    input_dir, output_file, impl, k = (
        sys.argv[4],
        sys.argv[5],
        sys.argv[6],
        int(sys.argv[7]),
    )
    table_slots = int(sys.argv[8]) if len(sys.argv) > 8 else 0
    temp_dir = sys.argv[9] if len(sys.argv) > 9 else None
    ckpt_dir = sys.argv[10] if len(sys.argv) > 10 else None
    ckpt_every = int(sys.argv[11]) if len(sys.argv) > 11 else 0
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4"
        ).strip()

    import jax

    # The workers run on virtual CPU devices whatever accelerator the host
    # has.
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, jax.devices()

    from kmer_counter.config import Options
    from kmer_counter.engine import MeshCountEngine

    crash_after = int(os.environ.get("KMER_TEST_CRASH_AFTER_CHUNKS", "0"))
    if crash_after:
        # Simulated crash for the kill/resume test: every process dies
        # after the same number of counter steps (deterministic, so the
        # collectives stay lockstep right up to the crash).
        from kmer_counter.parallel import pipeline as pl

        def wrap(cls):
            orig = cls.step
            state = {"n": 0}

            def step(self, reads):
                if state["n"] >= crash_after:
                    print(f"proc {pid} simulated crash", flush=True)
                    os._exit(17)
                state["n"] += 1
                return orig(self, reads)

            cls.step = step

        wrap(pl.ShardedCounter)
        wrap(pl.ShardedCounter2)

    opts = Options(
        kmer_length=k,
        canonical=True,
        input_dir=input_dir,
        output_file=output_file,
        table_impl=impl,
        reads_per_chunk=32,
        table_slots=table_slots or None,
        temp_dir=temp_dir,
        checkpoint_dir=ckpt_dir,
        checkpoint_every=ckpt_every,
        verbose=1 if ckpt_dir else 0,
    )
    stats = MeshCountEngine(opts).run()
    print(
        f"proc {pid} ok reads={stats.reads} "
        f"distinct={stats.distinct_kmers} spilled={stats.spilled_runs} "
        f"consolidations={stats.consolidations}",
        flush=True,
    )


if __name__ == "__main__":
    main()
