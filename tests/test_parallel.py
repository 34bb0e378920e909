"""Multi-device tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from kmer_counter import golden, records
from kmer_counter.parallel.mesh import make_mesh
from kmer_counter.parallel.pipeline import ShardedCounter
from kmer_counter.parallel.shuffle import owner_of


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def table_as_counter(lanes, counts, k):
    words = records.lanes_to_words(np.asarray(lanes))
    return {
        tuple(w): int(c)
        for w, c in zip(words.tolist(), np.asarray(counts).tolist())
        if c > 0
    }


def test_owner_monotonic():
    import jax.numpy as jnp

    lane0 = jnp.asarray(
        np.sort(np.random.default_rng(0).integers(0, 2**32, 10000, dtype=np.uint64))
        .astype(np.uint32)
    )
    owners = np.asarray(owner_of(lane0, 8))
    assert (np.diff(owners) >= 0).all()
    assert owners.min() >= 0 and owners.max() <= 7


@pytest.mark.parametrize("k,canonical", [(15, False), (31, True), (55, False)])
def test_sharded_counter_matches_golden(mesh8, make_reads, k, canonical):
    L = max(k + 15, 60)
    counter = ShardedCounter(
        mesh8,
        k,
        canonical,
        table_slots=4096,
        reads_per_device=4,
        line_length=L,
    )
    want = {}
    for _ in range(3):
        reads = make_reads(8 * 4, L, invalid_frac=0.03)
        for key, c in golden.count_reads(reads, k, canonical).items():
            want[key] = want.get(key, 0) + c
        counter.step(reads)
    lanes, counts = counter.finalize()
    got = table_as_counter(lanes, counts, k)
    assert got == want
    # Globally sorted ascending.
    keys = list(map(tuple, np.asarray(lanes).tolist()))
    assert keys == sorted(keys)


def test_sharded_counter_consolidation_pressure(mesh8, make_reads):
    k, L = 15, 40
    counter = ShardedCounter(
        mesh8, k, False, table_slots=256, reads_per_device=2, line_length=L
    )
    want = {}
    for _ in range(6):
        reads = make_reads(16, L)
        for key, c in golden.count_reads(reads, k).items():
            want[key] = want.get(key, 0) + c
        counter.step(reads)
    lanes, counts = counter.finalize()
    assert table_as_counter(lanes, counts, k) == want


def test_shuffle_overflow_detected(mesh8):
    # Keys that all share their leading 16 bits route to a single owner;
    # a too-small bucket capacity must be *detected*, never silently drop.
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from kmer_counter.parallel.mesh import DATA_AXIS
    from kmer_counter.parallel.shuffle import route_merge_local

    C, NL, cap = 64, 2, 8
    rng = np.random.default_rng(1)
    # 8*64 distinct keys, all with lane0 high bits zero → owner 0.
    lane0 = rng.permutation(2**16, )[: 8 * C].astype(np.uint32)
    lanes = np.stack([lane0, np.zeros_like(lane0)], axis=0)  # lane-major
    counts = np.ones(8 * C, np.uint32)

    def body(l, c):
        out = route_merge_local(jnp.asarray(l), jnp.asarray(c), DATA_AXIS, 8, cap)
        return out[3][None]

    fn = shard_map(
        body,
        mesh=mesh8,
        in_specs=(P(None, DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )
    overflow = np.asarray(fn(lanes, counts))
    assert (overflow > 0).all()
    assert overflow.max() >= C - cap


def test_shuffle_balanced_no_overflow(mesh8):
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from kmer_counter.parallel.mesh import DATA_AXIS
    from kmer_counter.parallel.shuffle import route_merge_local

    C, NL, cap = 64, 2, 32
    rng = np.random.default_rng(2)
    lanes = rng.integers(0, 2**32, size=(NL, 8 * C), dtype=np.uint64).astype(
        np.uint32
    )
    counts = np.ones(8 * C, np.uint32)

    def body(l, c):
        ol, oc, nu, ov = route_merge_local(
            jnp.asarray(l), jnp.asarray(c), DATA_AXIS, 8, cap
        )
        return ol, oc, nu[None], ov[None]

    fn = shard_map(
        body,
        mesh=mesh8,
        in_specs=(P(None, DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
    )
    out_lanes, out_counts, nuniq, overflow = fn(lanes, counts)
    assert int(np.max(np.asarray(overflow))) == 0
    # Every input key survived the routing.
    got = set()
    block = 8 * cap
    out_lanes, out_counts = np.asarray(out_lanes), np.asarray(out_counts)
    for d in range(8):
        u = int(np.asarray(nuniq)[d])
        for row in out_lanes[:, d * block : d * block + u].T:
            got.add(tuple(row.tolist()))
    want = {tuple(r.tolist()) for r in lanes.T}
    assert got == want


def test_sharded_matches_single_device(mesh8, make_reads):
    from kmer_counter.ops import count_chunk

    k, L = 31, 60
    reads = make_reads(32, L, invalid_frac=0.02)
    counter = ShardedCounter(
        mesh8, k, False, table_slots=2048, reads_per_device=4, line_length=L
    )
    counter.step(reads)
    lanes_m, counts_m = counter.finalize()
    import jax.numpy as jnp

    lanes_s, counts_s, n_s = count_chunk(jnp.asarray(reads), k, False)
    got_single = table_as_counter(
        np.asarray(lanes_s)[:, : int(n_s)].T, np.asarray(counts_s)[: int(n_s)], k
    )
    assert table_as_counter(lanes_m, counts_m, k) == got_single


def test_finalize_local_matches_finalize(mesh8, make_reads):
    # Single-process: concatenating finalize_local parts in mesh order must
    # equal the gathered finalize() result (the multi-host dump path).
    k, L = 15, 40
    c1 = ShardedCounter(mesh8, k, False, table_slots=2048, reads_per_device=4, line_length=L)
    c2 = ShardedCounter(mesh8, k, False, table_slots=2048, reads_per_device=4, line_length=L)
    reads = make_reads(32, L)
    c1.step(reads)
    c2.step(reads)
    lanes, counts = c1.finalize()
    parts = c2.finalize_local()
    assert [p[0] for p in parts] == sorted(p[0] for p in parts)
    lanes2 = np.concatenate([p[1] for p in parts])
    counts2 = np.concatenate([p[2] for p in parts])
    np.testing.assert_array_equal(lanes, lanes2)
    np.testing.assert_array_equal(counts, counts2)


def test_sampled_splitters_balance_skewed_keys(mesh8, make_reads):
    """VERDICT r4 item 4: canonical keys are min(fwd, revcomp), hence
    systematically biased toward the low half of the key space — the
    uniform lead-lane split leaves high-rank devices near-empty.  The
    sampled-splitter routing must keep max/mean device load <= 1.5x with
    no overflow retries on exactly this regime."""
    import jax.numpy as jnp

    from kmer_counter.parallel.shuffle import owner_of

    k, L = 31, 60
    counter = ShardedCounter(
        mesh8, k, True, table_slots=8192, reads_per_device=16, line_length=L
    )
    for _ in range(4):
        counter.step(make_reads(8 * 16, L))
    cap_before = counter.bucket_cap
    lanes, counts, nuniq, overflow = counter._route_with_retry()
    assert counter.bucket_cap == cap_before, "overflow retry should not fire"
    loads = np.array(
        [int(np.asarray(s.data)[0]) for s in nuniq.addressable_shards]
    )
    assert loads.sum() > 0
    mean = loads.sum() / len(loads)
    assert loads.max() <= 1.5 * mean, f"skewed loads: {loads.tolist()}"

    # The uniform split on the same keys is demonstrably skewed (this is
    # the regime the sampled splitters exist for): canonical lead lanes
    # live in the low half, so the top half of the devices sit empty.
    flat_counts = np.asarray(jax.device_get(counter.counts))
    flat_lane0 = np.asarray(jax.device_get(counter.lanes))[0]
    live = flat_counts > 0
    uniform_owner = np.asarray(owner_of(jnp.asarray(flat_lane0[live]), 8))
    uniform_loads = np.bincount(uniform_owner, minlength=8)
    assert uniform_loads.max() > 1.5 * uniform_loads.mean()
