"""Training loop: per-graph Adam steps, early stopping, best-restore.

Port of ``gcn_maxcut_tpu/train/loop.py`` (``per_graph`` step mode, STE
loss).  One epoch runs the reference loss chain — GCNSoftmax →
``pin_terminals`` → ``ste_argmax_onehot`` → ``compute_loss`` — and one
Adam step per graph, in dataset order; the epoch's loss is the sum of the
per-graph losses.  Early stopping and the restore of the best epoch's
parameters follow the JAX package's semantics exactly:

  * patience grows when the epoch loss is worse than the previous epoch's
    or moves by at most ``tolerance`` (from the second epoch on), and
    resets otherwise;
  * when patience reaches ``config.patience`` training stops at that
    epoch, which is not eligible as "best";
  * the returned parameters are those after the best epoch's updates.

In adjacency-feature mode the node features are the padded adjacency and
the embedding table gets no update, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import Graph, dense_adjacency, pad_graph_batch
from gcn_maxcut_tpu_torch.data.process import ProcessedDataset
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.models.gcn import (
    GCNSoftmax,
    embedding_init,
    gcn_softmax_apply,
)
from gcn_maxcut_tpu_torch.objectives.cut_loss import compute_loss
from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.optim import Adam

_F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class TrainState:
    model: GCNSoftmax
    embed: torch.Tensor
    optimizer: Adam
    config: TrainingConfig

    def params(self) -> Dict[str, Any]:
        """Detached copy in the JAX layout: {"conv1", "conv2", "embed"}."""
        tree = self.model.params()
        return {
            "conv1": {k: v.detach().clone() for k, v in tree["conv1"].items()},
            "conv2": {k: v.detach().clone() for k, v in tree["conv2"].items()},
            "embed": self.embed.detach().clone(),
        }


def _check_ported(config: TrainingConfig) -> None:
    waiting = {
        "step_mode": (config.step_mode, "per_graph"),
        "lr_schedule": (config.lr_schedule, "constant"),
        "loss_mode": (config.loss_mode, "ste"),
        "entropy_weight": (config.entropy_weight, 0.0),
        "save_directory": (config.save_directory, None),
    }
    for name, (value, ported) in waiting.items():
        if value != ported:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


def setup_train_state(
    config: TrainingConfig,
    params: Optional[Dict[str, Any]] = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Model, embedding table and Adam (torch's defaults: b1 = 0.9,
    b2 = 0.999, eps = 1e-8).

    ``params``: initial parameters in the JAX layout (``convert.
    params_from_jax``); by default they are drawn from ``config.seed`` with
    a ``torch.Generator``.  The embedding joins the optimizer only in
    embedding-feature mode.
    """
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        model = GCNSoftmax.init(
            config.dim_embedding, config.hidden_dim, config.number_classes,
            gen, dev, config.dropout,
        )
        embed = embedding_init(config.n_nodes, config.dim_embedding, gen, dev)
    else:
        model = GCNSoftmax(
            {k: {n: t.to(dev).clone() for n, t in params[k].items()}
             for k in ("conv1", "conv2")},
            config.dropout,
        )
        embed = params["embed"].to(dev).clone()
    trained = list(model.parameters())
    if config.feature_mode == "embedding":
        embed.requires_grad_(True)
        trained.append(embed)
    optimizer = Adam(trained, config.learning_rate, b1=0.9, b2=0.999, eps=1e-8)
    return TrainState(model, embed, optimizer, config)


def _embed_rows(embed: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Fit the (n_nodes, dim) embedding table to the graph's n_pad rows."""
    n_table = embed.shape[0]
    if n_pad <= n_table:
        return embed[:n_pad]
    return torch.nn.functional.pad(embed, (0, 0, 0, n_pad - n_table))


def _resolve_dense_aggregation(
    aggregation: str, n_pad: int, n_graphs: int = 1
) -> bool:
    """Aggregation backend: "dense" makes it an n_pad × n_pad matmul (and,
    in adjacency-feature mode, reuses the dense adjacency as the features
    with W1's first n_pad rows); "auto" picks dense for small padded graphs
    whose densified batch stays small."""
    if aggregation == "dense":
        return True
    if aggregation == "sparse":
        return False
    return n_pad <= 2048 and n_graphs * n_pad * n_pad <= (1 << 27)


def _graph_loss(
    params: Dict[str, Any],
    g: Graph,
    config: TrainingConfig,
    generator: torch.Generator | None,
    a_mask: torch.Tensor | None = None,
    a_feat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference loss chain for one graph.  ``a_feat`` is the weighted
    adjacency as [n_pad, min(n_pad, dim_embedding)] features: the reference's
    feature columns past n_pad are zero, so ``x @ W1 == a_feat @ W1[:width]``."""
    conv1 = params["conv1"]
    if config.feature_mode == "adjacency":
        if a_feat is not None:
            x = a_feat
            conv1 = dict(conv1, w=conv1["w"][: a_feat.shape[-1]])
        else:
            x = dense_adjacency(g, width=config.dim_embedding)
    else:
        x = _embed_rows(params["embed"], g.n_pad)
    probs = gcn_softmax_apply(
        {"conv1": conv1, "conv2": params["conv2"]}, g, x,
        dropout=config.dropout, train=True, generator=generator,
        a_dense=a_mask,
    )
    onehot = ste_argmax_onehot(pin_terminals(probs))
    return compute_loss(
        g, onehot, A=config.A, C=config.C,
        penalty=config.penalty if config.use_penalty else 0.0,
        num_terminals=3,
    )


def _dense_inputs(
    graphs: List[Graph], config: TrainingConfig
) -> List[Tuple[torch.Tensor | None, torch.Tensor | None]]:
    """Per-graph (a_mask, a_feat), built once per run on the dense path."""
    n_pad = graphs[0].n_pad
    if not _resolve_dense_aggregation(config.aggregation, n_pad, len(graphs)):
        return [(None, None)] * len(graphs)
    width = min(n_pad, config.dim_embedding)
    return [
        (
            dense_adjacency(g, values="mask"),
            dense_adjacency(g, width=width)
            if config.feature_mode == "adjacency" else None,
        )
        for g in graphs
    ]


def _params_tree(state: TrainState) -> Dict[str, Any]:
    return {**state.model.params(), "embed": state.embed}


def _run_epoch(
    state: TrainState,
    graphs: List[Graph],
    dense: List[Tuple[torch.Tensor | None, torch.Tensor | None]],
    generator: torch.Generator,
) -> float:
    """One Adam step per graph; returns the summed float32 loss."""
    config = state.config
    state.model.train()
    losses = []
    for g, (a_mask, a_feat) in zip(graphs, dense):
        loss = _graph_loss(
            _params_tree(state), g, config, generator, a_mask, a_feat
        )
        grads = torch.autograd.grad(loss, state.optimizer.params)
        state.optimizer.step(grads)
        losses.append(loss.detach())
    return float(torch.stack(losses).sum())


def train_model(
    dataset_batch: Graph,
    config: TrainingConfig,
    state: TrainState | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    device: str | torch.device | None = None,
) -> Tuple[Dict[str, Any], float, int, torch.Tensor, List[float]]:
    """Epoch loop with early stopping and best-restore.

    ``dataset_batch`` is the stacked `Graph` from ``pad_graph_batch``; it is
    moved to the state's device.  Returns ``(params, best_loss,
    final_epoch, embed, history)`` with ``params`` the best epoch's, in the
    JAX layout.
    """
    _check_ported(config)
    state = state or setup_train_state(config, device=device)
    dev = state.embed.device
    batch = dataset_batch.to(dev)
    graphs = [batch.index(i) for i in range(batch.n_nodes.shape[0])]
    dense = _dense_inputs(graphs, config)
    generator = torch.Generator(device=dev).manual_seed(config.seed + 1)

    history: List[float] = []
    best_loss = prev_loss = np.float32(_F32_MAX)
    tolerance = np.float32(config.tolerance)
    patience = 0
    best_params = state.params()
    for epoch in range(config.number_epochs):
        loss = np.float32(_run_epoch(state, graphs, dense, generator))
        history.append(float(loss))
        worse = epoch > 0 and (loss > prev_loss or abs(prev_loss - loss) <= tolerance)
        patience = patience + 1 if worse else 0
        stop = patience >= config.patience
        if not stop and loss < best_loss:
            best_loss = loss
            best_params = state.params()
        prev_loss = loss
        if callback is not None:
            callback(epoch, float(loss))
        if stop:
            break

    best = float(best_loss)
    return best_params, (float("inf") if best >= _F32_MAX else best), \
        len(history) - 1, best_params["embed"], history


def train_dataset(
    dataset: ProcessedDataset,
    model_name: str | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    device: str | torch.device | None = None,
    **config_kwargs,
) -> Tuple[Dict[str, Any], float, int, torch.Tensor, List[float]]:
    """Train on a processed dataset; ``n_nodes`` (the feature width)
    defaults to the dataset's ``max_nodes``."""
    config = TrainingConfig(**{
        "n_nodes": dataset.config.max_nodes,
        "save_directory": model_name,
        **config_kwargs,
    })
    batch = pad_graph_batch([dataset.graphs[k] for k in sorted(dataset.graphs)])
    return train_model(batch, config, callback=callback, device=device)


@torch.no_grad()
def evaluate_model(
    params: Dict[str, Any], dataset_batch: Graph, config: TrainingConfig
) -> Dict[str, float]:
    """Average no-grad loss over the dataset; ``-average_loss`` reads as the
    estimated average cut.  Runs on the device that holds ``params``."""
    dev = params["conv1"]["w"].device
    batch = dataset_batch.to(dev)
    n = int(batch.n_nodes.shape[0])
    losses = []
    for i in range(n):
        g = batch.index(i)
        if config.feature_mode == "adjacency":
            x = dense_adjacency(g, width=config.dim_embedding)
        else:
            x = _embed_rows(params["embed"], g.n_pad)
        a = (
            dense_adjacency(g, values="mask")
            if _resolve_dense_aggregation(config.aggregation, g.n_pad, n)
            else None
        )
        probs = gcn_softmax_apply(
            {"conv1": params["conv1"], "conv2": params["conv2"]}, g, x,
            a_dense=a,
        )
        onehot = ste_argmax_onehot(pin_terminals(probs))
        losses.append(compute_loss(g, onehot, A=config.A, C=config.C))
    total = float(torch.stack(losses).sum())
    return {
        "total_loss": total,
        "average_loss": total / n,
        "num_graphs": n,
        "estimated_avg_cut": -total / n,
    }
