"""Card tests: the consolidation ops at real sizes on the GPU, against
NumPy.  They skip on a host without a GPU (the ``gpu`` fixtures decide);
run them on the card with ``pytest -m gpu``."""

import numpy as np
import pytest

from kmer_counter import golden, records
from kmer_counter.config import Options
from kmer_counter.engine import plan_chunks
from kmer_counter.utils.seqgen import random_genome, sample_reads

pytestmark = pytest.mark.gpu

ROWS = 1 << 24


def _pool(rng, m, NL):
    """Sorted distinct keys ``[U, NL]`` uint32, none all-ones."""
    keys = rng.integers(0, 2**31, size=(m, NL), dtype=np.uint64).astype(np.uint32)
    keys = keys[np.lexsort(keys.T[::-1])]
    head = np.concatenate([[True], (keys[1:] != keys[:-1]).any(axis=1)])
    return keys[head]


def _fold(lanes, counts):
    """Live rows of a sorted table with duplicate-key runs summed."""
    keep = counts > 0
    lanes, counts = lanes[keep], counts[keep].astype(np.uint64)
    head = np.concatenate([[True], (lanes[1:] != lanes[:-1]).any(axis=1)])
    return lanes[head], np.add.reduceat(counts, np.flatnonzero(head))


@pytest.mark.parametrize("NL", [2, 4, 7])
def test_sort_reduce_on_gpu(gpu, NL):
    import jax

    from kmer_counter.ops.sortcount import sort_reduce

    rng = np.random.default_rng(NL)
    pool = _pool(rng, ROWS // 16, NL)
    idx = rng.integers(0, len(pool), ROWS)
    counts = rng.integers(0, 4, ROWS).astype(np.uint32)
    lanes = jax.device_put(np.ascontiguousarray(pool[idx].T), gpu)
    totals = np.bincount(idx, weights=counts, minlength=len(pool))
    u_lanes, u_counts, n = jax.jit(sort_reduce)(lanes, jax.device_put(counts, gpu))
    n = int(n)
    keep = totals > 0
    assert n == int(keep.sum())
    np.testing.assert_array_equal(np.asarray(u_lanes)[:, :n].T, pool[keep])
    u_counts = np.asarray(u_counts)
    np.testing.assert_array_equal(u_counts[:n], totals[keep].astype(np.uint32))
    assert np.all(u_counts[n:] == 0)


@pytest.mark.parametrize("NL", [2, 4, 7])
def test_consolidate2_on_gpu(gpu, NL):
    import jax

    from kmer_counter.ops import table2 as t2

    rng = np.random.default_rng(10 + NL)
    CP = ROWS // 4
    CR = ROWS - CP
    pool = _pool(rng, ROWS // 16, NL)
    sel = np.sort(rng.choice(len(pool), len(pool) // 2, replace=False))
    p_lanes = np.zeros((NL, CP), np.uint32)
    p_counts = np.zeros(CP, np.uint32)
    p_lanes[:, : len(sel)] = pool[sel].T
    p_counts[: len(sel)] = rng.integers(1, 6, len(sel))
    idx = rng.integers(0, len(pool), CR)
    raw_off = CR - 1000  # rows past raw_off are stale and must be ignored
    table = jax.device_put(
        t2.TwoLevelTable(
            p_lanes, p_counts, np.ascontiguousarray(pool[idx].T),
            np.int32(raw_off), np.uint32(0),
        ),
        gpu,
    )
    totals = np.bincount(sel, weights=p_counts[: len(sel)], minlength=len(pool))
    totals += np.bincount(idx[:raw_off], minlength=len(pool))
    out, live, lost = t2.consolidate2(table)
    assert int(lost) == 0
    live = int(live)
    lanes = np.asarray(out.prefix_lanes)[:, :live].T
    keys, counts = _fold(lanes, np.asarray(out.prefix_counts)[:live])
    keep = totals > 0
    np.testing.assert_array_equal(keys, pool[keep])
    np.testing.assert_array_equal(counts, totals[keep].astype(np.uint64))


def test_count_step_two_level_on_gpu(gpu):
    """One chunk at the shape plan_chunks gives chip_smoke's main phase."""
    import jax

    from kmer_counter.ops import table2 as t2
    from kmer_counter.ops.pipeline import count_step_two_level

    k, L = 31, 100
    opts = Options(kmer_length=k, canonical=True, memory_limit_bytes=8_000_000_000)
    reads_per_chunk, _ = plan_chunks(opts, L)
    rng = np.random.default_rng(31)
    reads = sample_reads(rng, random_genome(rng, 4_600_000), reads_per_chunk, L, 0.002)
    width = reads_per_chunk * (L - k + 1)
    NL = records.active_lanes(k)
    table = jax.device_put(t2.make_table2(1024, width, NL), gpu)
    table = count_step_two_level(table, jax.device_put(reads, gpu), k, True)
    assert int(table.raw_off) == width
    raw = np.asarray(table.raw_lanes).astype(np.uint64)
    live = ~(raw == 0xFFFFFFFF).all(axis=0)
    got = np.sort((raw[0] << np.uint64(32) | raw[1])[live])
    want = np.sort(golden.window_keys(reads, k, True)[:, 0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["one", "two"])
def test_sharded_counter_on_four_gpus(gpus4, impl):
    from kmer_counter.parallel.mesh import make_mesh
    from kmer_counter.parallel.pipeline import ShardedCounter, ShardedCounter2

    k, L, per_dev = 31, 100, 4096
    mesh = make_mesh(devices=gpus4)
    rng = np.random.default_rng(4)
    genome = random_genome(rng, 200_000)
    chunks = [sample_reads(rng, genome, 4 * per_dev, L, 0.002) for _ in range(3)]
    slots = 8 * per_dev * (L - k + 1)
    if impl == "two":
        counter = ShardedCounter2(
            mesh, k, True, prefix_slots=slots, raw_slots=slots,
            reads_per_device=per_dev, line_length=L,
        )
    else:
        counter = ShardedCounter(
            mesh, k, True, table_slots=slots, reads_per_device=per_dev,
            line_length=L,
        )
    for reads in chunks:
        counter.step(reads)
    lanes, counts = counter.finalize()
    words = records.lanes_to_words(lanes)
    want_words, want_counts = golden.numpy_count_table(chunks, k, True)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(counts, want_counts)
