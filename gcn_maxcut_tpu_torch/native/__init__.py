"""native: ctypes bindings for ``native/libgraphtools.so`` (see bindings.py).

The JAX package's seven names, then the port's own: the library itself
and the bindings of the METIS-style partition, the symmetry check and the
shard assembly, which the JAX package calls from its modules.
"""

from gcn_maxcut_tpu_torch.native.bindings import (
    bfs_partition_native,
    brute_force_maxcut_native,
    build,
    greedy_maxcut_native,
    is_available,
    library,
    metis_partition_native,
    random_regular_edges_native,
    shard_assembly_native,
    sort_by_receiver_native,
    symmetry_check_native,
)

__all__ = [
    "is_available",
    "build",
    "random_regular_edges_native",
    "sort_by_receiver_native",
    "bfs_partition_native",
    "brute_force_maxcut_native",
    "greedy_maxcut_native",
    "library",
    "metis_partition_native",
    "shard_assembly_native",
    "symmetry_check_native",
]
