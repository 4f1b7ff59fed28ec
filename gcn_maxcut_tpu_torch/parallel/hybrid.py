"""Hybrid data × graph parallelism: a batch of graphs over the rows of a
2-D ``("data", "graph")`` mesh, each graph node-sharded over its row.

Port of ``gcn_maxcut_tpu/parallel/hybrid.py``.  The batch's graphs are
split over the data axis (B/R graphs a row, in order), and each graph's
nodes over its row's graph ring (``parallel.mesh.Mesh2D.row``), where the
sharded SpMM of ``parallel/spmm.py`` runs unchanged; hop 0 of every shard
runs K1 (``ops/block_ell.block_ell_spmm``) when ``shard_graph`` attached
a plan.  An epoch:

  * the giant trainer's forward (``parallel/giant.py``) and loss −cut for
    each graph on its row;
  * the conv gradients summed over the graphs and divided by B; each
    graph's embedding blocks get only their own gradient;
  * one Adam step over the conv parameters and every graph's embedding.

Differences from the JAX module, all deliberate:

  * The step is eager and runs one epoch (``make_hybrid_step``; no
    ``epochs_per_call``, as for the port's giant trainer), and
    ``stack_sharded_graphs`` keeps each graph as it is: the padding of
    ``e_group`` and of the ELL and plan widths is a stacking artefact of
    ``shard_map``.  So every graph keeps its own hop-0 plan, where JAX
    drops all plans when their geometries differ; that changes which
    kernel runs, never the result.
  * The port takes the true embedding gradient.  The JAX step
    differentiates a loss holding a ``psum`` inside ``shard_map``
    (``parallel/spmm.py:284``), so its embedding gradient is D times the
    true one; Adam hides the factor up to its eps.
  * Initial parameters are numpy draws from ``config.seed``, or the
    caller's in the JAX layout (``params``: ``{"conv1", "conv2", "embed":
    [B, D, n_shard, F]}``), so both packages can start from one draw.

Across processes (``parallel.mesh.multi_host_init``), rank p holds its
rows' graphs; the conv gradients and the loss are summed over the ranks by
one ``all_reduce`` an epoch (``parallel.mesh.data_axis_sum``), the "one
small conv-param pmean" the JAX module expects to cross hosts, and
``train_hybrid`` gathers the per-graph cuts so that every rank returns the
whole batch's.  The graph axis stays inside a process.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig, GiantState, _forward, _partition
from gcn_maxcut_tpu_torch.parallel.mesh import (
    Mesh,
    Mesh2D,
    data_axis_sum,
    local_devices,
    make_mesh,
    process_group,
)
from gcn_maxcut_tpu_torch.parallel.partition import ShardedGraph, shard_graph
from gcn_maxcut_tpu_torch.parallel.spmm import sharded_cut_edgeform
from gcn_maxcut_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def stack_sharded_graphs(sgs: Sequence[ShardedGraph]) -> Tuple[ShardedGraph, ...]:
    """The batch of B equally sharded graphs, each kept with its own edge
    groups, tables and hop-0 plan; the JAX function's checks."""
    if not sgs:
        raise ValueError("need at least one ShardedGraph")
    if len({sg.num_shards for sg in sgs}) != 1:
        raise ValueError("graphs must share num_shards")
    if len({sg.n_shard for sg in sgs}) != 1:
        raise ValueError("graphs must share n_shard (same n, same padding)")
    if len({sg.symmetric for sg in sgs}) != 1:
        raise ValueError("graphs must share the symmetric flag")
    if len({sg.ell_senders is not None for sg in sgs}) != 1:
        raise ValueError("graphs must consistently have/not have ELL tables")
    return tuple(sgs)


def _rows_of(sgb: Sequence[ShardedGraph], mesh: Mesh2D, data_axis: str,
             graph_axis: str) -> List[Mesh]:
    """The graph ring of each of this process's graphs (B/R a row, in order)."""
    if not isinstance(mesh, Mesh2D) or mesh.axis_names != (data_axis, graph_axis):
        raise ValueError(f"a hybrid run needs a ({data_axis!r}, {graph_axis!r}) mesh, got {mesh}")
    d = mesh.axis_size(graph_axis)
    if sgb[0].num_shards != d:
        raise ValueError(f"graphs sharded {sgb[0].num_shards}-way != mesh graph axis {d}")
    if len(sgb) % len(mesh.rows):
        raise ValueError(f"batch {len(sgb) * process_group()[0]} must divide data axis "
                         f"{mesh.axis_size(data_axis)}")
    per_row = len(sgb) // len(mesh.rows)
    return [mesh.rows[i // per_row] for i in range(len(sgb))]


def _local_grads(state: GiantState, graphs: Sequence[ShardedGraph], rows: Sequence[Mesh],
                 config: GiantConfig) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """This process's graphs: the summed loss, the per-graph losses (on the
    conv parameters' device) and the gradient of the sum for every leaf."""
    dev0 = state.conv["conv1"]["w"].device
    d = rows[0].size
    losses = []
    for b, (sg, row) in enumerate(zip(graphs, rows)):
        onehot = _forward(state.conv, state.embeds[b * d:(b + 1) * d], sg, row, config)
        losses.append(-sharded_cut_edgeform(sg, onehot, row, config.schedule).to(dev0))
    per_graph = torch.stack(losses)
    total = per_graph.sum()
    return total.detach(), per_graph.detach(), torch.autograd.grad(total, state.leaves())


def make_hybrid_step(
    sgb: Sequence[ShardedGraph],
    mesh: Mesh2D,
    config: GiantConfig,
    state: GiantState,
    data_axis: str = "data",
    graph_axis: str = "graph",
) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """One epoch of hybrid training a call, updating ``state`` in place.

    ``sgb``: this process's graphs (``stack_sharded_graphs``; all B in one
    process), B/R a row in order.  ``state``: the conv parameters and, for
    each graph in turn, its D embedding blocks on its row's devices
    (``GiantState.from_blocks``).  The step returns the epoch's mean loss
    over all B graphs and this process's per-graph losses, both before the
    update, as tensors on the conv parameters' device.
    """
    rows = _rows_of(sgb, mesh, data_axis, graph_axis)
    graphs = [sg.to(row) for sg, row in zip(sgb, rows)]
    b_total = len(graphs) * process_group()[0]

    def step() -> Tuple[torch.Tensor, torch.Tensor]:
        total, per_graph, grads = _local_grads(state, graphs, rows, config)
        *conv, total = data_axis_sum([*grads[:4], total.reshape(1)])
        state.optimizer.step([*(g / b_total for g in conv), *grads[4:]])
        return total[0] / b_total, per_graph

    return step


def train_hybrid(
    edge_lists: List[Tuple[np.ndarray, np.ndarray]],
    n: int,
    config: GiantConfig = GiantConfig(),
    mesh: Mesh2D | None = None,
    data_axis: str = "data",
    graph_axis: str = "graph",
    mesh_shape: Tuple[int, int] | None = None,
    params: Dict[str, Any] | None = None,
) -> Dict[str, Any]:
    """End-to-end hybrid trainer: B graphs -> 2-D mesh -> per-graph cuts.

    ``edge_lists``: B ``(senders, receivers)`` directed COO pairs, all over
    ``n`` nodes (every rank passes all B; each keeps its rows' graphs).
    ``mesh``: default the CUDA devices (raises without CUDA), ``mesh_shape``
    (R, D) or 2 × ndev/2 when ndev is even and above 1, else 1 × ndev; under
    a process group of W ranks, one row a rank over its own card(s).
    ``params``: initial parameters in the JAX layout, ``embed`` [B, D,
    n_shard, F].  ``per_graph_cuts`` is minus the final epoch's per-graph
    losses, for the whole batch on every rank.
    """
    from gcn_maxcut_tpu_torch.bench.giant_demo import _synchronize  # bench imports giant
    from gcn_maxcut_tpu_torch.bench.locality import locality_params

    if config.number_epochs < 1:
        raise ValueError(f"number_epochs must be >= 1, got {config.number_epochs}")
    world, _ = process_group()
    if mesh is None:
        devs = local_devices()
        if mesh_shape is None:
            r = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
            mesh_shape = (world, len(devs)) if world > 1 else (r, len(devs) // r)
        mesh = make_mesh((data_axis, graph_axis), shape=mesh_shape, devices=devs)
    if not isinstance(mesh, Mesh2D):
        raise ValueError(f"train_hybrid needs a ({data_axis!r}, {graph_axis!r}) mesh, got {mesh}")
    R, D = mesh.axis_size(data_axis), mesh.axis_size(graph_axis)
    B = len(edge_lists)
    if B % R:
        raise ValueError(f"batch {B} must divide data axis {R}")
    lo = mesh.first_row * (B // R)
    hi = lo + len(mesh.rows) * (B // R)

    sgs = []
    for s, r_ in edge_lists[lo:hi]:
        sg, _ = shard_graph(
            s, r_, n, D, owner=_partition(s, r_, n, D, config.partition),
            local_reorder=config.local_reorder, block_ell=config.block_ell,
            block_ell_outlier_frac=config.block_ell_outlier_frac,
        )
        sgs.append(sg)
    sgb = stack_sharded_graphs(sgs)
    n_shard = sgb[0].n_shard

    if params is None:
        params = locality_params(B * D * n_shard, config.dim_embedding, config.hidden_dim,
                                 config.num_classes, config.seed)
        params["embed"] = params["embed"].reshape(B, D, n_shard, -1)
    embed = np.asarray(params["embed"], dtype=np.float32)
    if embed.shape[:3] != (B, D, n_shard):
        raise ValueError(f"embedding {embed.shape} for {B} graphs of {D} shards of {n_shard}")
    rows = _rows_of(sgb, mesh, data_axis, graph_axis)
    state = GiantState.from_blocks(
        {**params, "embed": embed[lo:hi].reshape(-1, n_shard, embed.shape[-1])},
        [dev for row in rows for dev in row.devices], config.learning_rate)
    step = make_hybrid_step(sgb, mesh, config, state, data_axis, graph_axis)

    t0 = time.perf_counter()
    history = []
    for epoch in range(config.number_epochs):
        mean_loss, per_graph = step()
        if epoch % config.log_every == 0:
            history.append(float(mean_loss))
            logger.info("hybrid epoch %d: mean loss %.1f", epoch, history[-1])
    _synchronize(mesh.devices)
    train_time = time.perf_counter() - t0
    if dist.is_available() and dist.is_initialized():
        parts = [torch.empty_like(per_graph) for _ in range(world)]
        dist.all_gather(parts, per_graph)
        per_graph = torch.cat(parts)
    return {
        "final_mean_loss": float(mean_loss),
        "per_graph_cuts": (-per_graph).tolist(),
        "loss_history": history,
        "train_time_s": train_time,
        "epochs": config.number_epochs,
        "mesh_shape": (R, D),
        "num_graphs": B,
    }
