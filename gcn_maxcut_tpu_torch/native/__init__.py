"""native: ctypes bindings for ``native/libgraphtools.so`` (see bindings.py)."""

from gcn_maxcut_tpu_torch.native.bindings import (
    bfs_partition_native,
    is_available,
    library,
    metis_partition_native,
    random_regular_edges_native,
    shard_assembly_native,
    sort_by_receiver_native,
    symmetry_check_native,
)

__all__ = [
    "bfs_partition_native",
    "is_available",
    "library",
    "metis_partition_native",
    "random_regular_edges_native",
    "shard_assembly_native",
    "sort_by_receiver_native",
    "symmetry_check_native",
]
