"""Data-parallel training over the graph batch axis.

Port of ``gcn_maxcut_tpu/parallel/data_parallel.py``: the stacked batch's
leading axis is split over a data mesh (``parallel.mesh.make_mesh(
("data",), devices=...)``, a device per entry, which may repeat), every
entry sums the per-graph gradients of the recipe's loss
(``train/loop._graph_loss``) over its graphs, the sums are added over the
entries and divided by the graph count, and one Adam step follows.  The
epoch's loss is the sum over all graphs, the reference's scale.

Synchronous DP averages the per-graph gradients of the whole batch where
the reference steps per graph (standard minibatch semantics, as in JAX).

The port steps eagerly: ``make_dp_epoch_fn`` returns ``epoch_fn(state,
batch_shards, generator=None) -> loss``, which updates ``state`` (a
``train/loop.TrainState``) in place through ``optimizer`` (the Adam over
its trained leaves, normally ``state.optimizer``).  The parameters live on
the first entry's device and each entry uses its copy, as
``parallel/spmm.sharded_gcn_conv`` does; autograd adds the copies'
gradients.  Each entry aggregates as the recipe loop does
(``train/loop.epoch_inputs``: dense operators at the recipe's n_pad, where
the JAX function takes the sparse path), built at every call.  Dropout:
where JAX folds its key with the entry's index, the port draws every
entry's masks from ``generator`` in turn (on the entries' device type).

Across processes (``parallel.mesh.multi_host_init``): a data mesh of E
entries on each of W ranks is a data axis of W·E entries;
``shard_batch_for_dp`` keeps the rank's graphs, and the gradients, the loss
and the graph count are summed over the ranks by one ``all_reduce``
(``parallel.mesh.data_axis_sum``), which any process group takes, a group
of one included.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, data_axis_sum, process_group
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import TrainState, _graph_loss, _params_tree, epoch_inputs
from gcn_maxcut_tpu_torch.train.optim import Adam


def _check_axis(mesh: Mesh, axis: str) -> None:
    if not isinstance(mesh, Mesh) or mesh.axis_name != axis:
        raise ValueError(f"data parallelism needs a 1-D mesh named {axis!r}, got {mesh}")


def shard_batch_for_dp(batch: Graph, mesh: Mesh, axis: str = "data") -> List[Graph]:
    """The stacked batch (``pad_graph_batch``) split over the data axis:
    this process's entries' stacked graphs, entry e's on ``mesh.devices[e]``.

    The batch size must divide by the data axis (every rank's entries; pad
    the dataset with replica graphs if needed).
    """
    _check_axis(mesh, axis)
    world, rank = process_group()
    entries = world * mesh.size
    b = int(batch.n_nodes.shape[0])
    if b % entries:
        raise ValueError(f"batch {b} must divide data axis {entries}")
    per = b // entries
    first = rank * mesh.size
    return [batch.index(slice((first + e) * per, (first + e + 1) * per)).to(dev)
            for e, dev in enumerate(mesh.devices)]


def make_dp_epoch_fn(
    config: TrainingConfig,
    optimizer: Adam,
    mesh: Mesh,
    axis: str = "data",
) -> Callable[..., float]:
    """``epoch_fn(state, batch_shards, generator=None) -> loss``: one
    synchronous data-parallel epoch over ``shard_batch_for_dp``'s shards."""
    _check_axis(mesh, axis)
    dev0 = mesh.devices[0]

    def epoch_fn(state: TrainState, batch_shards: Sequence[Graph],
                 generator: torch.Generator | None = None) -> float:
        if len(batch_shards) != mesh.size:
            raise ValueError(f"{len(batch_shards)} shards for a data mesh of {mesh.size}")
        params = _params_tree(state)
        total = torch.zeros((), device=dev0)
        count = 0
        for shard, dev in zip(batch_shards, mesh.devices):
            local = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                         else v.to(dev)) for k, v in params.items()}
            inputs = epoch_inputs(shard, config)
            for i, g in enumerate(inputs.graphs):
                loss = _graph_loss(local, g, config, generator, *inputs.dense(i))
                total = total + loss.to(dev0)
            count += len(inputs.graphs)
        grads = torch.autograd.grad(total, optimizer.params)
        *grads, loss_sum, n_total = data_axis_sum(
            [*grads, total.detach(), torch.tensor(float(count), device=dev0)])
        optimizer.step([g / n_total for g in grads])
        return float(loss_sum)

    return epoch_fn
