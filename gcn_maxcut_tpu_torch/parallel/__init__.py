"""parallel: see the counterpart in gcn_maxcut_tpu/parallel/.

A mesh is a ring of torch devices, or rows of rings on a (data, graph)
mesh, and ``multi_host_init`` joins processes over ``torch.distributed``
(``mesh.py``).  On a ring: the node-sharded banded path
(``giant_banded.py``, the halo giant trainers on K5 and K6) and the
general one (``partition.py``, ``spmm.py``, ``giant.py``: any graph
partitioned into shards, the ring or all-gather SpMM, the giant trainer of
BASELINE config 4).  Over the data axis: data-parallel recipe training
(``data_parallel.py``) and the hybrid data × graph trainer (``hybrid.py``).
"""

from gcn_maxcut_tpu_torch.parallel.data_parallel import make_dp_epoch_fn, shard_batch_for_dp

from gcn_maxcut_tpu_torch.parallel.giant import (
    GiantConfig,
    decode_assignment,
    measure_epoch_time,
    sharded_cut,
    train_giant_graph,
)
from gcn_maxcut_tpu_torch.parallel.hybrid import (
    make_hybrid_step,
    stack_sharded_graphs,
    train_hybrid,
)
from gcn_maxcut_tpu_torch.parallel.mesh import (
    Mesh,
    Mesh2D,
    device_count,
    make_mesh,
    multi_host_init,
)
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
    "Mesh2D",
    "ShardedGraph",
    "decode_assignment",
    "device_count",
    "is_symmetric_coo",
    "make_dp_epoch_fn",
    "make_hybrid_step",
    "make_mesh",
    "make_sharded_spmm",
    "measure_epoch_time",
    "multi_host_init",
    "partition_nodes_bfs",
    "partition_nodes_contiguous",
    "partition_nodes_metis",
    "partition_quality",
    "shard_batch_for_dp",
    "shard_graph",
    "sharded_cut",
    "sharded_cut_edgeform",
    "sharded_gcn_conv",
    "sharded_spmm_allgather",
    "sharded_spmm_ring",
    "sharded_spmm_sym",
    "stack_sharded_graphs",
    "train_giant_graph",
    "train_hybrid",
]
