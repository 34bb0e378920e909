"""Sharded count pipeline: data-parallel counting + prefix-routed merge.

The multi-chip generalization of the single-device engine loop: reads are
row-sharded over the mesh's ``data`` axis, each device runs the same
encode→extract→sort-count step on its rows and appends into its own HBM
table shard, and the finalize step routes every record to its key-range
owner with one all_to_all (parallel.shuffle) — the reference's disk merge
tree (SURVEY.md §3.3) collapsed into a single collective.

All steps are jitted ``shard_map`` programs over a ``jax.sharding.Mesh``,
so the same code drives 1 chip, 1 host with N chips, or an N-host slice
(where jax.distributed makes the mesh span processes).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from kmer_counter.ops.encode import encode_reads
from kmer_counter.ops.extract import extract_kmer_lanes
from kmer_counter.ops.sortcount import sort_reduce
from kmer_counter.parallel.mesh import DATA_AXIS
from kmer_counter.parallel.shuffle import (
    route_merge_local,
    sampled_splitters_host,
)


def _global_max_int(x: int) -> int:
    """Max of a per-process int across all processes (identity when
    single-process) — post-consolidation bounds gate the next collective,
    so every process must agree on them."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return int(
            np.max(multihost_utils.process_allgather(np.array([x], np.int32)))
        )
    return x


def _global_sum_int(x: int) -> int:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return int(
            np.sum(multihost_utils.process_allgather(np.array([x], np.int64)))
        )
    return x


def _stage_reads_on(mesh, reads):
    """Read chunk → global device array sharded over the data axis.

    A jax.Array passes through untouched (pre-staged device-resident
    reads — benchmarks stage chunks outside their timed loops so the
    measurement isolates device + collective throughput from the host
    transfer).  Host
    arrays: each process passes only its devices' rows; the global array
    is assembled block-per-process (the step is a collective that every
    process must enter in lockstep).
    """
    if isinstance(reads, jax.Array):
        return reads
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    if jax.process_count() > 1:
        global_shape = (reads.shape[0] * jax.process_count(), reads.shape[1])
        return jax.make_array_from_process_local_data(
            sharding, reads, global_shape
        )
    return jax.device_put(reads, sharding)


def _place_by_position(mesh, spec, global_shape, dtype, block_for):
    """Assemble a sharded global array from per-position host blocks.

    ``block_for(pos)`` returns the numpy block for mesh position ``pos``;
    it is called only for this process's addressable devices, so every
    process contributes exactly its shards (the checkpoint-restore path —
    the inverse of reading ``addressable_shards``)."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    arrays = []
    for pos, d in enumerate(mesh.devices.flat):
        if d.process_index != jax.process_index():
            continue
        arrays.append(jax.device_put(np.ascontiguousarray(block_for(pos)), d))
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sharding, arrays
    )


class ShardedCounter:
    """Device-sharded count table with a chunked update step.

    Host-facing contract mirrors ops.table: the host tracks a worst-case
    per-device offset bound and calls consolidate()/finalize() at the right
    times; only those calls synchronize (one small transfer each).
    """

    def __init__(
        self,
        mesh,
        k: int,
        canonical: bool,
        table_slots: int,
        reads_per_device: int,
        line_length: int,
        merge_slack: float = 4.0,
    ):
        self.mesh = mesh
        self.k = k
        self.canonical = canonical
        self.D = mesh.devices.size
        self.table_slots = table_slots  # per device
        self.reads_per_device = reads_per_device
        self.line_length = line_length
        self._merge_slack = merge_slack
        self.chunk_slots = reads_per_device * (line_length - k + 1)
        if self.chunk_slots <= 0:
            raise ValueError("line_length shorter than k")
        if self.chunk_slots > table_slots:
            raise ValueError("per-device chunk exceeds table capacity")
        from kmer_counter.records import active_lanes

        self.NL = active_lanes(k)
        # Per-destination bucket capacity for the merge all_to_all.
        self.bucket_cap = int(min(table_slots, table_slots * merge_slack / self.D))

        # Record arrays are lane-major [NL, slots]; the slot axis is the
        # sharded one.  Zeros are created *on device* with the target
        # sharding (host device_put cannot populate non-addressable shards
        # on a multi-process mesh).
        self._lanes_spec = P(None, DATA_AXIS)

        def zeros(shape, dtype, spec):
            return jax.jit(
                lambda: jnp.zeros(shape, dtype),
                out_shardings=NamedSharding(mesh, spec),
            )()

        self.lanes = zeros((self.NL, self.D * table_slots), jnp.uint32, self._lanes_spec)
        self.counts = zeros((self.D * table_slots,), jnp.uint32, P(DATA_AXIS))
        self.offsets = zeros((self.D,), jnp.int32, P(DATA_AXIS))
        self.host_bound = 0  # worst-case per-device offset

        # Frozen sampled range splitters ([D-1] uint32, replicated) — set
        # at the first routing and reused for every later one, so spill
        # epochs and the final merge always cut identical per-position
        # ranges (see route_merge_local's contract).  None until then
        # (and forever when D == 1).
        self._splitters = None

        self._step = self._build_step()
        self._consolidate = self._build_consolidate()
        self._finalize = self._build_finalize()

    # ---- jitted programs -------------------------------------------------

    def _build_step(self):
        k, canonical = self.k, self.canonical
        mesh = self.mesh

        def local_step(lanes, counts, offset, reads):
            # Raw extract + append — no per-chunk sort; duplicate-collapse
            # happens in the amortized consolidation (see ops.pipeline
            # extract_chunk for the rationale).
            codes, valid = encode_reads(reads)
            win_lanes, win_valid = extract_kmer_lanes(codes, valid, k, canonical)
            NL, R, Pw = win_lanes.shape
            c_lanes = win_lanes.reshape(NL, R * Pw)
            c_counts = win_valid.reshape(R * Pw).astype(jnp.uint32)
            lanes = jax.lax.dynamic_update_slice(
                lanes, c_lanes, (jnp.int32(0), offset[0])
            )
            counts = jax.lax.dynamic_update_slice(counts, c_counts, (offset[0],))
            return lanes, counts, offset + jnp.int32(R * Pw)

        fn = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
            out_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        )
        return jax.jit(fn, donate_argnums=(0, 1, 2))

    def _build_consolidate(self):
        def local_consolidate(lanes, counts, offset):
            del offset
            out_lanes, out_counts, num_unique = sort_reduce(lanes, counts)
            return out_lanes, out_counts, num_unique[None].astype(jnp.int32)

        fn = shard_map(
            local_consolidate,
            mesh=self.mesh,
            in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        )
        return jax.jit(fn, donate_argnums=(0, 1, 2))

    def _build_finalize(self):
        D, cap = self.D, self.bucket_cap

        def local_finalize(lanes, counts, offset, splitters):
            del offset
            # Local collapse first: shrinks the routed volume.
            l, c, _ = sort_reduce(lanes, counts)
            out_lanes, out_counts, num_unique, overflow = route_merge_local(
                l, c, DATA_AXIS, D, cap, splitters=splitters
            )
            return (
                out_lanes,
                out_counts,
                num_unique[None].astype(jnp.int32),
                overflow[None].astype(jnp.int32),
            )

        fn = shard_map(
            local_finalize,
            mesh=self.mesh,
            in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
        )
        return jax.jit(fn)

    def _ensure_splitters(self):
        """Compute-and-freeze the sampled splitters on first use (requires
        a consolidated table; every process runs this in lockstep — the
        sample pooling is a deterministic host all-gather)."""
        if self.D > 1 and self._splitters is None:
            self.consolidate()
            self._splitters = sampled_splitters_host(
                self.mesh,
                self.lanes,
                self.counts,
                self.table_slots,
                self.D,
            )
        return self._splitters

    # ---- host-facing API -------------------------------------------------

    def _stage_reads(self, reads):
        return _stage_reads_on(self.mesh, reads)

    def step(self, reads: np.ndarray):
        """Process one global chunk of shape [D*reads_per_device, L] (a
        pre-staged sharded jax.Array passes through, see
        _stage_reads_on)."""
        if self.host_bound + self.chunk_slots > self.table_slots:
            self.consolidate()
            if self.host_bound + self.chunk_slots > self.table_slots:
                # Cardinality outgrew the plan: double capacity (rare; the
                # reference's equivalent pressure valve was spilling sorted
                # runs to disk, SURVEY.md §3.3).
                new_slots = self.table_slots
                while self.host_bound + self.chunk_slots > new_slots:
                    new_slots *= 2
                self._grow(new_slots)
        dev_reads = self._stage_reads(reads)
        self.lanes, self.counts, self.offsets = self._step(
            self.lanes, self.counts, self.offsets, dev_reads
        )
        self.host_bound += self.chunk_slots

    def _grow(self, new_slots: int):
        """Host-side capacity doubling of every table shard (rare)."""
        if jax.process_count() > 1:
            raise MemoryError(
                "table shard full on a multi-process mesh: raise tableSlots "
                "/ gpuMemoryLimit (dynamic growth is single-process only)"
            )
        old = self.table_slots
        lanes = np.asarray(jax.device_get(self.lanes)).reshape(
            self.NL, self.D, old
        )
        counts = np.asarray(jax.device_get(self.counts)).reshape(self.D, old)
        new_lanes = np.zeros((self.NL, self.D, new_slots), np.uint32)
        new_counts = np.zeros((self.D, new_slots), np.uint32)
        new_lanes[:, :, :old] = lanes
        new_counts[:, :old] = counts
        self.lanes = jax.device_put(
            new_lanes.reshape(self.NL, self.D * new_slots),
            NamedSharding(self.mesh, self._lanes_spec),
        )
        self.counts = jax.device_put(
            new_counts.reshape(self.D * new_slots),
            NamedSharding(self.mesh, P(DATA_AXIS)),
        )
        self.table_slots = new_slots
        self.bucket_cap = int(
            min(new_slots, new_slots * self._merge_slack / self.D)
        )
        # Shapes changed: rebuild the jitted programs.
        self._step = self._build_step()
        self._consolidate = self._build_consolidate()
        self._finalize = self._build_finalize()

    def consolidate(self):
        self.lanes, self.counts, self.offsets = self._consolidate(
            self.lanes, self.counts, self.offsets
        )
        # The post-consolidation bound must be identical on every process
        # (it gates the next collective), so take the global max.
        local = max(
            int(np.asarray(s.data)[0]) for s in self.offsets.addressable_shards
        )
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            local = int(
                np.max(
                    multihost_utils.process_allgather(np.array([local], np.int32))
                )
            )
        self.host_bound = local

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Merge across devices; returns (sorted keys [U, NL] row-major,
        counts [U]) — host layout, ready for records.lanes_to_words.

        The result is globally sorted because the routing is monotonic in
        the key and devices are concatenated in mesh order.

        Key-space skew beyond ``merge_slack`` is handled, not fatal: the
        routing step is not donated, so on detected bucket overflow the
        merge re-runs with doubled bucket capacity until it fits
        (cap == table_slots always fits: a device can receive at most
        every record of every table).  The reference's analog pressure
        point is the merge tree's unbounded intermediate files
        (KMerFileMergeHandler.cpp:49-100).
        """
        lanes, counts, nuniq, overflow = self._route_with_retry()
        nuniq = np.asarray(jax.device_get(nuniq))
        lanes = np.asarray(jax.device_get(lanes))  # [NL, D * block]
        counts = np.asarray(jax.device_get(counts))
        block = self.D * self.bucket_cap
        parts_l, parts_c = [], []
        for d in range(self.D):
            u = int(nuniq[d])
            parts_l.append(lanes[:, d * block : d * block + u].T)
            parts_c.append(counts[d * block : d * block + u])
        return np.concatenate(parts_l), np.concatenate(parts_c)

    def _route_with_retry(self):
        """Run the finalize routing, doubling the per-destination bucket
        capacity on detected overflow (the state is not donated, so a
        retry sees it intact).  Every process observes the same global-max
        overflow flag, so mesh-wide rebuild/retry stays in lockstep."""
        splitters = self._ensure_splitters()
        if splitters is None:  # D == 1: uniform trivial partition
            splitters = jnp.zeros((0,), jnp.uint32)
        while True:
            lanes, counts, nuniq, overflow = self._finalize(
                self.lanes, self.counts, self.offsets, splitters
            )
            local_over = max(
                (
                    int(np.asarray(s.data)[0])
                    for s in overflow.addressable_shards
                ),
                default=0,
            )
            if _global_max_int(local_over) == 0:
                return lanes, counts, nuniq, overflow
            if self.bucket_cap >= self.table_slots:
                raise MemoryError(
                    "merge bucket overflow at maximum capacity: "
                    "inconsistent table state"
                )
            self.bucket_cap = min(self.bucket_cap * 2, self.table_slots)
            self._finalize = self._build_finalize()

    def finalize_local(self) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Multi-host variant of finalize(): merge across the mesh, then
        return only this process's addressable range tables as
        (mesh_position, keys [U, NL] row-major, counts [U]) tuples.

        Each host writes its own ranges (the engine names them by mesh
        position); concatenating all parts in mesh-position order yields
        exactly the globally sorted table, with no cross-host gather.
        """
        lanes, counts, nuniq, overflow = self._route_with_retry()
        block = self.D * self.bucket_cap
        nuniq_by_pos = {}
        for shard in nuniq.addressable_shards:
            pos = shard.index[0].start or 0
            nuniq_by_pos[pos] = int(np.asarray(shard.data)[0])
        counts_by_pos = {
            (s.index[0].start or 0) // block: np.asarray(s.data)
            for s in counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // block: np.asarray(s.data)
            for s in lanes.addressable_shards
        }
        out = []
        for pos in sorted(counts_by_pos):
            u = nuniq_by_pos[pos]
            out.append(
                (pos, lanes_by_pos[pos][:, :u].T, counts_by_pos[pos][:u])
            )
        return out

    def local_tables(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """This process's per-device consolidated partial tables as
        (keys [U, NL] row-major, counts [U]) sorted runs — the spill
        export (no collective)."""
        self.consolidate()
        out = []
        block = self.table_slots
        counts_by_pos = {
            (s.index[0].start or 0) // block: np.asarray(s.data)
            for s in self.counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // block: np.asarray(s.data)
            for s in self.lanes.addressable_shards
        }
        for pos in sorted(counts_by_pos):
            c = counts_by_pos[pos]
            keep = c > 0
            out.append((lanes_by_pos[pos][:, keep].T, c[keep]))
        return out

    def export_positions(self) -> list[tuple[int, np.ndarray, np.ndarray, int]]:
        """Checkpoint export: consolidated per-position state as
        (mesh_position, keys [U, NL] row-major, counts [U], allt=0) for
        this process's addressable positions.  Collective-free beyond the
        consolidation — each process snapshots exactly its shards."""
        self.consolidate()
        out = []
        block = self.table_slots
        counts_by_pos = {
            (s.index[0].start or 0) // block: np.asarray(s.data)
            for s in self.counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // block: np.asarray(s.data)
            for s in self.lanes.addressable_shards
        }
        for pos in sorted(counts_by_pos):
            c = counts_by_pos[pos]
            keep = c > 0
            out.append((pos, lanes_by_pos[pos][:, keep].T, c[keep], 0))
        return out

    def import_positions(self, items, splitters=None):
        """Checkpoint restore: the inverse of export_positions.  Every
        process calls this in lockstep with its own positions' data; the
        capacity decision (growth for the restored cardinality) is agreed
        via a host all-gather so the mesh stays consistent."""
        by_pos = {pos: (l, c) for pos, l, c, _ in items}
        max_u = _global_max_int(
            max((len(c) for _, c in by_pos.values()), default=0)
        )
        new_slots = self.table_slots
        while max_u + self.chunk_slots > new_slots:
            new_slots *= 2
        if new_slots != self.table_slots:
            self.table_slots = new_slots
            self.bucket_cap = int(
                min(new_slots, new_slots * self._merge_slack / self.D)
            )
            self._step = self._build_step()
            self._consolidate = self._build_consolidate()
            self._finalize = self._build_finalize()
        NL, slots = self.NL, self.table_slots

        def lanes_block(pos):
            b = np.zeros((NL, slots), np.uint32)
            if pos in by_pos:
                l, _ = by_pos[pos]
                b[:, : l.shape[0]] = l.T
            return b

        def counts_block(pos):
            b = np.zeros((slots,), np.uint32)
            if pos in by_pos:
                _, c = by_pos[pos]
                b[: len(c)] = c
            return b

        def offset_block(pos):
            u = len(by_pos[pos][1]) if pos in by_pos else 0
            return np.asarray([u], np.int32)

        self.lanes = _place_by_position(
            self.mesh, self._lanes_spec, (NL, self.D * slots), np.uint32,
            lanes_block,
        )
        self.counts = _place_by_position(
            self.mesh, P(DATA_AXIS), (self.D * slots,), np.uint32,
            counts_block,
        )
        self.offsets = _place_by_position(
            self.mesh, P(DATA_AXIS), (self.D,), np.int32, offset_block
        )
        self.host_bound = max_u
        if splitters is not None:
            self._splitters = jax.device_put(
                jnp.asarray(np.asarray(splitters, np.uint32)),
                NamedSharding(self.mesh, P()),
            )

    def reset(self):
        """Empty the table (post-spill restart), keeping buffers."""

        def local_zero(counts, offsets):
            return jnp.zeros_like(counts), jnp.zeros_like(offsets)

        fn = shard_map(
            local_zero,
            mesh=self.mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        )
        self.counts, self.offsets = jax.jit(fn, donate_argnums=(0, 1))(
            self.counts, self.offsets
        )
        self.host_bound = 0

    def allt_total(self) -> int:
        """One-level tables carry the all-T key in-band (counts move with
        keys, so no sentinel ambiguity): nothing out of band."""
        return 0

    def pending_consolidation(self) -> bool:
        """True when the next step() will consolidate first."""
        return self.host_bound + self.chunk_slots > self.table_slots

    def occupied_bound(self) -> int:
        """Upper bound on live records per device (host-mirrored, so every
        process computes the same value — safe to gate collectives on)."""
        return self.host_bound


class ShardedCounter2:
    """Two-level device-sharded count table (the mesh form of ops.table2).

    Each device owns a keys-only raw region (sentinel-encoded, no count
    operand moves through the dedup sort) plus a consolidated sorted
    prefix; consolidation runs ops.table2.consolidate2 *inside*
    ``shard_map``, so the single-device path and the mesh path are the
    same code.  Finalize keeps ShardedCounter's
    prefix-routed all_to_all (the reference's disk merge tree,
    KMerFileMergeHandler.cpp:49-100, collapsed into one collective), with
    bucket-overflow retry instead of a fatal error.

    Host-facing contract: the raw offset is host-mirrored exactly (appends
    advance by the static chunk width; consolidation resets to 0), and the
    live prefix bound is the global max over devices after each
    consolidation.  The all-T side count (k % 16 == 0, forward mode — the
    key that is bit-identical to the sentinel, see ops.table2) accumulates
    per device and is summed at finalize; callers re-materialize the T^k
    record at the very end of the dump.
    """

    def __init__(
        self,
        mesh,
        k: int,
        canonical: bool,
        prefix_slots: int,
        raw_slots: int,
        reads_per_device: int,
        line_length: int,
        merge_slack: float = 4.0,
    ):
        from kmer_counter.records import active_lanes

        self.mesh = mesh
        self.k = k
        self.canonical = canonical
        self.D = mesh.devices.size
        self.reads_per_device = reads_per_device
        self.line_length = line_length
        self._merge_slack = merge_slack
        self.chunk_slots = reads_per_device * (line_length - k + 1)
        if self.chunk_slots <= 0:
            raise ValueError("line_length shorter than k")
        self.CP = max(prefix_slots, 1)
        self.CR = max(raw_slots, self.chunk_slots)
        self.NL = active_lanes(k)
        self.bucket_cap = int(
            min(self.CP, max(self.CP * merge_slack / self.D, 1))
        )
        self.raw_bound = 0   # raw slots in use (host-mirrored, exact)
        self.live_bound = 0  # live prefix rows (global max, exact)

        def zeros(shape, dtype, spec):
            return jax.jit(
                lambda: jnp.zeros(shape, dtype),
                out_shardings=NamedSharding(self.mesh, spec),
            )()

        D = self.D
        self.prefix_lanes = zeros(
            (self.NL, D * self.CP), jnp.uint32, P(None, DATA_AXIS)
        )
        self.prefix_counts = zeros((D * self.CP,), jnp.uint32, P(DATA_AXIS))
        self.raw_lanes = zeros(
            (self.NL, D * self.CR), jnp.uint32, P(None, DATA_AXIS)
        )
        self.raw_off = zeros((D,), jnp.int32, P(DATA_AXIS))
        self.allt = zeros((D,), jnp.uint32, P(DATA_AXIS))

        # Frozen sampled range splitters — same contract as ShardedCounter
        # (set at first routing, reused so spill epochs and the final
        # merge cut identical ranges).
        self._splitters = None

        self._step = self._build_step()
        self._consolidate = self._build_consolidate()
        self._route = self._build_route()

    # ---- jitted programs -------------------------------------------------

    def _build_step(self):
        from kmer_counter.ops.pipeline import extract_chunk_keys

        k, canonical = self.k, self.canonical

        def local_step(raw_lanes, raw_off, allt, reads):
            lanes, chunk_allt = extract_chunk_keys(reads, k, canonical)
            raw = jax.lax.dynamic_update_slice(
                raw_lanes, lanes, (jnp.int32(0), raw_off[0])
            )
            return (
                raw,
                raw_off + jnp.int32(lanes.shape[1]),
                allt + chunk_allt[None],
            )

        fn = shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
            out_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        )
        return jax.jit(fn, donate_argnums=(0, 1, 2))

    def _build_consolidate(self):
        from kmer_counter.ops import table2 as t2

        def local_consolidate(p_lanes, p_counts, raw_lanes, raw_off):
            table = t2.TwoLevelTable(
                p_lanes, p_counts, raw_lanes, raw_off[0], jnp.uint32(0)
            )
            out, live, lost = t2.consolidate2(table)
            return (
                out.prefix_lanes,
                out.prefix_counts,
                out.raw_lanes,
                jnp.zeros_like(raw_off),
                live[None].astype(jnp.int32),
                lost[None].astype(jnp.int32),
            )

        fn = shard_map(
            local_consolidate,
            mesh=self.mesh,
            in_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(None, DATA_AXIS),
                P(DATA_AXIS),
            ),
            out_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
        )
        return jax.jit(fn, donate_argnums=(0, 1, 2, 3))

    def _build_route(self):
        D, cap = self.D, self.bucket_cap

        def local_route(lanes, counts, splitters):
            out_lanes, out_counts, num_unique, overflow = route_merge_local(
                lanes, counts, DATA_AXIS, D, cap, splitters=splitters
            )
            return (
                out_lanes,
                out_counts,
                num_unique[None].astype(jnp.int32),
                overflow[None].astype(jnp.int32),
            )

        fn = shard_map(
            local_route,
            mesh=self.mesh,
            in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(
                P(None, DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
                P(DATA_AXIS),
            ),
        )
        return jax.jit(fn)

    def _ensure_splitters(self):
        """Compute-and-freeze the sampled splitters on first use (requires
        a consolidated prefix; lockstep across processes — the sample
        pooling is a deterministic host all-gather)."""
        if self.D > 1 and self._splitters is None:
            if self.raw_bound > 0:
                self.consolidate()
            self._splitters = sampled_splitters_host(
                self.mesh,
                self.prefix_lanes,
                self.prefix_counts,
                self.CP,
                self.D,
            )
        return self._splitters

    def _grow_prefix(self, new_cp: int):
        """Device-side prefix growth (works on any mesh, multi-process
        included — no host gather of non-addressable shards)."""
        NL, CP = self.NL, self.CP

        def local_grow(p_lanes, p_counts):
            pl = jnp.zeros((NL, new_cp), jnp.uint32)
            pl = jax.lax.dynamic_update_slice(pl, p_lanes, (0, 0))
            pc = jnp.zeros((new_cp,), jnp.uint32)
            pc = jax.lax.dynamic_update_slice(pc, p_counts, (0,))
            return pl, pc

        fn = shard_map(
            local_grow,
            mesh=self.mesh,
            in_specs=(P(None, DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(None, DATA_AXIS), P(DATA_AXIS)),
        )
        self.prefix_lanes, self.prefix_counts = jax.jit(
            fn, donate_argnums=(0, 1)
        )(self.prefix_lanes, self.prefix_counts)
        self.CP = new_cp
        self.bucket_cap = int(
            min(self.CP, max(self.CP * self._merge_slack / self.D, 1))
        )
        # Shapes changed: rebuild the shape-bound programs.
        self._consolidate = self._build_consolidate()
        self._route = self._build_route()

    # ---- host-facing API -------------------------------------------------

    def _stage_reads(self, reads):
        return _stage_reads_on(self.mesh, reads)

    def step(self, reads: np.ndarray):
        """Process one global chunk of shape [D*reads_per_device, L] (a
        pre-staged sharded jax.Array passes through, see
        _stage_reads_on)."""
        if self.raw_bound + self.chunk_slots > self.CR:
            self.consolidate()
        dev_reads = self._stage_reads(reads)
        self.raw_lanes, self.raw_off, self.allt = self._step(
            self.raw_lanes, self.raw_off, self.allt, dev_reads
        )
        self.raw_bound += self.chunk_slots

    def consolidate(self):
        """Merge every device's raw region into its prefix.  Pre-grows the
        prefix so truncation is impossible (live + raw bounds the distinct
        keys a consolidation can produce)."""
        if self.live_bound + self.raw_bound > self.CP:
            # Geometric growth: every new prefix shape recompiles the
            # shard_map consolidation — bound the shapes to O(log).
            self._grow_prefix(
                max(self.live_bound + self.raw_bound, 2 * self.CP)
            )
        (
            self.prefix_lanes,
            self.prefix_counts,
            self.raw_lanes,
            self.raw_off,
            live,
            lost,
        ) = self._consolidate(
            self.prefix_lanes, self.prefix_counts, self.raw_lanes, self.raw_off
        )
        local_live = max(
            (int(np.asarray(s.data)[0]) for s in live.addressable_shards),
            default=0,
        )
        local_lost = max(
            (int(np.asarray(s.data)[0]) for s in lost.addressable_shards),
            default=0,
        )
        if _global_max_int(local_lost) > 0:
            raise RuntimeError(
                "mesh consolidation truncated live records: prefix "
                "pre-grow invariant violated"
            )
        self.live_bound = _global_max_int(local_live)
        self.raw_bound = 0

    def allt_total(self) -> int:
        """Global sum of the per-device all-T side counters."""
        local = sum(
            int(np.asarray(s.data)[0]) for s in self.allt.addressable_shards
        )
        return _global_sum_int(local)

    def pending_consolidation(self) -> bool:
        """True when the next step() will consolidate first."""
        return self.raw_bound + self.chunk_slots > self.CR

    def occupied_bound(self) -> int:
        """Upper bound on live records per device (host-mirrored, so every
        process computes the same value — safe to gate collectives on)."""
        return self.live_bound + self.raw_bound

    def _route_with_retry(self):
        if self.raw_bound > 0:
            self.consolidate()
        splitters = self._ensure_splitters()
        if splitters is None:  # D == 1: uniform trivial partition
            splitters = jnp.zeros((0,), jnp.uint32)
        while True:
            lanes, counts, nuniq, overflow = self._route(
                self.prefix_lanes, self.prefix_counts, splitters
            )
            local_over = max(
                (
                    int(np.asarray(s.data)[0])
                    for s in overflow.addressable_shards
                ),
                default=0,
            )
            if _global_max_int(local_over) == 0:
                return lanes, counts, nuniq
            if self.bucket_cap >= self.CP:
                raise MemoryError(
                    "merge bucket overflow at maximum capacity: "
                    "inconsistent table state"
                )
            self.bucket_cap = min(self.bucket_cap * 2, self.CP)
            self._route = self._build_route()

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Cross-device prefix-routed merge; returns (keys [U, NL]
        row-major, counts [U]), globally sorted.  The all-T side count is
        NOT included — callers append the T^k record via allt_total()."""
        lanes, counts, nuniq = self._route_with_retry()
        nuniq = np.asarray(jax.device_get(nuniq))
        lanes = np.asarray(jax.device_get(lanes))
        counts = np.asarray(jax.device_get(counts))
        block = self.D * self.bucket_cap
        parts_l, parts_c = [], []
        for d in range(self.D):
            u = int(nuniq[d])
            parts_l.append(lanes[:, d * block : d * block + u].T)
            parts_c.append(counts[d * block : d * block + u])
        return np.concatenate(parts_l), np.concatenate(parts_c)

    def finalize_local(self) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Multi-host finalize: (mesh_position, keys [U, NL] row-major,
        counts [U]) for this process's addressable ranges only (see
        ShardedCounter.finalize_local)."""
        lanes, counts, nuniq = self._route_with_retry()
        block = self.D * self.bucket_cap
        nuniq_by_pos = {
            (s.index[0].start or 0): int(np.asarray(s.data)[0])
            for s in nuniq.addressable_shards
        }
        counts_by_pos = {
            (s.index[0].start or 0) // block: np.asarray(s.data)
            for s in counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // block: np.asarray(s.data)
            for s in lanes.addressable_shards
        }
        out = []
        for pos in sorted(counts_by_pos):
            u = nuniq_by_pos[pos]
            out.append(
                (pos, lanes_by_pos[pos][:, :u].T, counts_by_pos[pos][:u])
            )
        return out

    def local_tables(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """This process's per-device consolidated partial tables as
        (keys [U, NL] row-major, counts [U]) sorted runs — the spill
        export (no collective; each device's prefix is already a sorted
        run with live rows dense at the front)."""
        if self.raw_bound > 0:
            self.consolidate()
        out = []
        counts_by_pos = {
            (s.index[0].start or 0) // self.CP: np.asarray(s.data)
            for s in self.prefix_counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // self.CP: np.asarray(s.data)
            for s in self.prefix_lanes.addressable_shards
        }
        for pos in sorted(counts_by_pos):
            c = counts_by_pos[pos]
            keep = c > 0
            out.append((lanes_by_pos[pos][:, keep].T, c[keep]))
        return out

    def export_positions(self) -> list[tuple[int, np.ndarray, np.ndarray, int]]:
        """Checkpoint export: consolidated per-position state as
        (mesh_position, keys [U, NL] row-major, counts [U], allt) for
        this process's addressable positions (see ShardedCounter)."""
        if self.raw_bound > 0:
            self.consolidate()
        out = []
        counts_by_pos = {
            (s.index[0].start or 0) // self.CP: np.asarray(s.data)
            for s in self.prefix_counts.addressable_shards
        }
        lanes_by_pos = {
            (s.index[1].start or 0) // self.CP: np.asarray(s.data)
            for s in self.prefix_lanes.addressable_shards
        }
        allt_by_pos = {
            (s.index[0].start or 0): int(np.asarray(s.data)[0])
            for s in self.allt.addressable_shards
        }
        for pos in sorted(counts_by_pos):
            c = counts_by_pos[pos]
            keep = c > 0
            out.append(
                (pos, lanes_by_pos[pos][:, keep].T, c[keep], allt_by_pos[pos])
            )
        return out

    def import_positions(self, items, splitters=None):
        """Checkpoint restore (inverse of export_positions, lockstep —
        see ShardedCounter.import_positions)."""
        by_pos = {pos: (l, c, a) for pos, l, c, a in items}
        max_u = _global_max_int(
            max((len(c) for _, c, _ in by_pos.values()), default=0)
        )
        if max_u > self.CP:
            self.CP = max_u
            self.bucket_cap = int(
                min(self.CP, max(self.CP * self._merge_slack / self.D, 1))
            )
            self._consolidate = self._build_consolidate()
            self._route = self._build_route()
        NL, CP = self.NL, self.CP

        def lanes_block(pos):
            b = np.zeros((NL, CP), np.uint32)
            if pos in by_pos:
                l = by_pos[pos][0]
                b[:, : l.shape[0]] = l.T
            return b

        def counts_block(pos):
            b = np.zeros((CP,), np.uint32)
            if pos in by_pos:
                c = by_pos[pos][1]
                b[: len(c)] = c
            return b

        def allt_block(pos):
            a = by_pos[pos][2] if pos in by_pos else 0
            return np.asarray([a], np.uint32)

        self.prefix_lanes = _place_by_position(
            self.mesh, P(None, DATA_AXIS), (NL, self.D * CP), np.uint32,
            lanes_block,
        )
        self.prefix_counts = _place_by_position(
            self.mesh, P(DATA_AXIS), (self.D * CP,), np.uint32, counts_block
        )
        self.allt = _place_by_position(
            self.mesh, P(DATA_AXIS), (self.D,), np.uint32, allt_block
        )
        self.live_bound = max_u
        self.raw_bound = 0
        if splitters is not None:
            self._splitters = jax.device_put(
                jnp.asarray(np.asarray(splitters, np.uint32)),
                NamedSharding(self.mesh, P()),
            )

    def reset(self):
        """Empty the table (post-spill restart), keeping buffers and the
        accumulated all-T side count.  Zeroing the counts and the raw
        offset suffices: every consumer gates prefix rows on count > 0 and
        raw rows on position < raw_off."""

        def local_zero(p_counts, raw_off):
            return jnp.zeros_like(p_counts), jnp.zeros_like(raw_off)

        fn = shard_map(
            local_zero,
            mesh=self.mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        )
        self.prefix_counts, self.raw_off = jax.jit(fn, donate_argnums=(0, 1))(
            self.prefix_counts, self.raw_off
        )
        self.raw_bound = 0
        self.live_bound = 0
