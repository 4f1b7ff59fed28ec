"""parallel: see the counterpart in gcn_maxcut_tpu/parallel/.

A mesh is a ring of torch devices (``mesh.py``).  On it: the node-sharded
banded path (``giant_banded.py``, the halo giant trainers on K5 and K6) and
the general one (``partition.py``, ``spmm.py``, ``giant.py``: any graph
partitioned into shards, the ring or all-gather SpMM, the giant trainer of
BASELINE config 4).
"""

from gcn_maxcut_tpu_torch.parallel.giant import (
    GiantConfig,
    decode_assignment,
    measure_epoch_time,
    sharded_cut,
    train_giant_graph,
)
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh
from gcn_maxcut_tpu_torch.parallel.partition import (
    ShardedGraph,
    is_symmetric_coo,
    partition_nodes_bfs,
    partition_nodes_contiguous,
    partition_nodes_metis,
    partition_quality,
    shard_graph,
)
from gcn_maxcut_tpu_torch.parallel.spmm import (
    make_sharded_spmm,
    sharded_cut_edgeform,
    sharded_gcn_conv,
    sharded_spmm_allgather,
    sharded_spmm_ring,
    sharded_spmm_sym,
)

__all__ = [
    "GiantConfig",
    "Mesh",
    "ShardedGraph",
    "decode_assignment",
    "device_count",
    "is_symmetric_coo",
    "make_mesh",
    "make_sharded_spmm",
    "measure_epoch_time",
    "partition_nodes_bfs",
    "partition_nodes_contiguous",
    "partition_nodes_metis",
    "partition_quality",
    "shard_graph",
    "sharded_cut",
    "sharded_cut_edgeform",
    "sharded_gcn_conv",
    "sharded_spmm_allgather",
    "sharded_spmm_ring",
    "sharded_spmm_sym",
    "train_giant_graph",
]
