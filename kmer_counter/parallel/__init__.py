"""Multi-chip / multi-host parallelism.

The reference is single-GPU, single-process (SURVEY.md §2.3): its only
"distribution" is a disk-based merge tree over sorted spill files
(KMerFileMergeHandler/KMerFileMerger/SortedKMerFile).  Here that whole
subsystem is subsumed on-device (SURVEY.md §5 "Distributed communication
backend"):

  * reads are data-parallel over the mesh ('data' axis);
  * each device accumulates a partial count table in HBM (ops.table);
  * at merge time every record is routed to the device that owns its
    leading key-prefix range via one ``all_to_all`` over ICI/DCN
    (parallel.shuffle), and each owner sort-reduces its range locally;
  * the global dump is the per-device range tables concatenated in mesh
    order — already globally sorted, because the routing function is
    monotonic in the key.
"""

from kmer_counter.parallel.mesh import make_mesh
from kmer_counter.parallel.pipeline import ShardedCounter

__all__ = ["make_mesh", "ShardedCounter"]
