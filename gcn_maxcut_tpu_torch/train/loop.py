"""Training loop: Adam steps, early stopping, best-restore.

Port of ``gcn_maxcut_tpu/train/loop.py``.  The reference loss chain is
GCNSoftmax → ``pin_terminals`` → ``ste_argmax_onehot`` → ``compute_loss``;
``loss_mode="quantile"`` trains on the sampled decode's mean + c·std of
the pinned probabilities instead, and ``entropy_weight`` subtracts that
weight times the real nodes' entropy.  ``step_mode="per_graph"`` (the
reference) takes one Adam step per graph, in dataset order; ``"batched"``
one step an epoch on the summed loss.  Either way the epoch's loss is the
sum of the per-graph losses.  ``lr_schedule="cosine"`` decays the
learning rate over the run's steps as optax's ``cosine_decay_schedule``.
Early stopping and the restore of the best epoch's parameters follow the
JAX package's semantics exactly:

  * patience grows when the epoch loss is worse than the previous epoch's
    or moves by at most ``tolerance`` (from the second epoch on), and
    resets otherwise;
  * when patience reaches ``config.patience`` training stops at that
    epoch, which is not eligible as "best";
  * the returned parameters are those after the best epoch's updates.

In adjacency-feature mode the node features are the padded adjacency and
the embedding table gets no update, as in the reference.

With ``config.save_directory`` set, the loop writes a checkpoint
(``train/checkpoint.py``) every ``save_frequency`` epochs with the
parameters and optimizer state after that epoch, and a final one with the
best epoch's parameters; ``resume_from`` restores parameters, optimizer
state, epoch and history from a checkpoint of either package, as the JAX
package does.

Epochs run in chunks of ``config.epochs_per_call`` (``train/chunks.py``):
on the card a chunk is one captured CUDA graph replayed an epoch at a
time, and the host reads the chunk's losses and stop flags once.  So the
early stopping, the patience and the best-parameter copy live on the
device (``make_monitored_epoch_fn``): once a chunk's epoch stops, its
later epochs are frozen no-ops that leave the parameters, the Adam state
and its count as they were, and read ``prev_loss`` as their loss; any
chunk length gives the same run bit for bit.  With checkpoints on, a chunk
also ends at each ``save_frequency`` epoch, so a checkpoint holds that
epoch's own state (the JAX package writes the chunk's last state under
that epoch's name).
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
from gcn_maxcut_tpu_torch.objectives.cut_loss import (
    compute_loss,
    quantile_cut_loss,
    terminal_independence_penalty,
)
from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.train.checkpoint import (
    checkpoint_name,
    flatten_tree,
    load_checkpoint,
    save_checkpoint,
)
from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule

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

    def _adam_paths(self) -> List[str]:
        """The parameter path of each tensor the optimizer steps."""
        by_id = {id(t): k for k, t in flatten_tree(_params_tree(self)).items()}
        return [by_id[id(p)] for p in self.optimizer.params]

    def opt_state(self) -> Dict[str, Any]:
        """The Adam state in the JAX package's optax layout: ``{"0":
        {".count", ".mu", ".nu"}}``, and ``{"1": {".count"}}`` for the
        cosine schedule's step count, under ``.inner_state`` when the
        embedding is masked out (adjacency-feature mode)."""
        mu: Dict[str, Any] = {}
        nu: Dict[str, Any] = {}
        for path, m, v in zip(self._adam_paths(), self.optimizer.mu, self.optimizer.nu):
            *parents, leaf = path.split("/")
            dm, dv = mu, nu
            for p in parents:
                dm, dv = dm.setdefault(p, {}), dv.setdefault(p, {})
            dm[leaf], dv[leaf] = m.detach().clone(), v.detach().clone()
        count = torch.tensor(self.optimizer.count, dtype=torch.int32)
        inner = {"0": {".count": count, ".mu": mu, ".nu": nu}}
        if self.config.lr_schedule == "cosine":
            inner["1"] = {".count": count.clone()}
        return {".inner_state": inner} if self.config.feature_mode == "adjacency" else inner

    @torch.no_grad()
    def load(self, params: Dict[str, Any], opt_state: Dict[str, Any]) -> None:
        """Copy parameters (JAX layout) and an ``opt_state()``-shaped Adam
        state into this state."""
        for k in ("conv1", "conv2"):
            for n, t in getattr(self.model, k).params().items():
                t.copy_(params[k][n])
        self.embed.copy_(params["embed"])
        flat = flatten_tree(opt_state)
        prefix = ".inner_state/0" if self.config.feature_mode == "adjacency" else "0"
        paths = self._adam_paths()
        self.optimizer.load(int(flat[f"{prefix}/.count"]),
                            [flat[f"{prefix}/.mu/{p}"] for p in paths],
                            [flat[f"{prefix}/.nu/{p}"] for p in paths])


def setup_train_state(
    config: TrainingConfig,
    steps_per_epoch: int = 1,
    params: Optional[Dict[str, Any]] = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Model, embedding table and Adam (torch's defaults: b1 = 0.9,
    b2 = 0.999, eps = 1e-8).

    ``steps_per_epoch``: Adam steps an epoch (the graph count in
    ``per_graph`` step mode), which sizes the cosine schedule's horizon,
    ``number_epochs · steps_per_epoch`` steps, under ``lr_schedule=
    "cosine"``.  ``params``: initial parameters in the JAX layout
    (``convert.params_from_jax``); by default they are drawn from
    ``config.seed`` with a ``torch.Generator``.  The embedding joins the
    optimizer only in embedding-feature mode.
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
    lr: float | Callable[[int], float] = config.learning_rate
    if config.lr_schedule == "cosine":
        lr = cosine_decay_schedule(
            config.learning_rate,
            decay_steps=max(1, config.number_epochs * steps_per_epoch),
            alpha=config.lr_final_fraction,
        )
    optimizer = Adam(trained, lr, b1=0.9, b2=0.999, eps=1e-8)
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


def _graph_probs(
    params: Dict[str, Any],
    g: Graph,
    config: TrainingConfig,
    generator: torch.Generator | None,
    a_mask: torch.Tensor | None = None,
    a_feat: torch.Tensor | None = None,
) -> torch.Tensor:
    """GCNSoftmax's training forward for one graph, or for a stacked batch
    (``g`` from ``pad_graph_batch``, ``a_mask``/``a_feat`` [G, ...]).
    ``a_feat`` is the weighted adjacency as [n_pad, min(n_pad,
    dim_embedding)] features: the reference's feature columns past n_pad
    are zero, so ``x @ W1 == a_feat @ W1[:width]``."""
    conv1 = params["conv1"]
    if config.feature_mode == "adjacency":
        if a_feat is not None:
            x = a_feat
            conv1 = dict(conv1, w=conv1["w"][: a_feat.shape[-1]])
        else:
            x = dense_adjacency(g, width=config.dim_embedding)
    else:
        x = _embed_rows(params["embed"], g.n_pad)
    return gcn_softmax_apply(
        {"conv1": conv1, "conv2": params["conv2"]}, g, x,
        dropout=config.dropout, train=True, generator=generator,
        a_dense=a_mask,
    )


def _probs_loss(g: Graph, probs: torch.Tensor, config: TrainingConfig) -> torch.Tensor:
    """One graph's training loss from its class probabilities: the STE
    argmax cut (``loss_mode="ste"``) or the sampled decode's quantile
    (``"quantile"``, on the pinned probabilities), the terminal penalty
    under ``use_penalty``, less ``entropy_weight`` times the summed entropy
    of the real nodes' pinned rows."""
    pinned = pin_terminals(probs)
    penalty = config.penalty if config.use_penalty else 0.0
    if config.loss_mode == "quantile":
        loss = quantile_cut_loss(g, pinned, c=config.quantile_c, C=config.C)
        if penalty:
            loss = loss + penalty * terminal_independence_penalty(pinned, 3)
    else:
        loss = compute_loss(g, ste_argmax_onehot(pinned), A=config.A, C=config.C,
                            penalty=penalty, num_terminals=3)
    if config.entropy_weight:
        ent = -torch.sum(pinned * torch.log(pinned + 1e-12), dim=-1)
        loss = loss - config.entropy_weight * torch.sum(ent * g.node_mask)
    return loss


def _graph_loss(
    params: Dict[str, Any],
    g: Graph,
    config: TrainingConfig,
    generator: torch.Generator | None,
    a_mask: torch.Tensor | None = None,
    a_feat: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference loss chain for one graph."""
    return _probs_loss(g, _graph_probs(params, g, config, generator, a_mask, a_feat), config)


@dataclasses.dataclass
class EpochInputs:
    """What every epoch reads: the stacked batch, its graphs, and on the
    dense path the stacked unweighted adjacency ``a_mask`` [G, n_pad,
    n_pad] and, in adjacency-feature mode, the weighted one as features
    ``a_feat`` [G, n_pad, min(n_pad, dim_embedding)]; built once a run."""

    batch: Graph
    graphs: List[Graph]
    a_mask: torch.Tensor | None
    a_feat: torch.Tensor | None

    def dense(self, i: int) -> Tuple[torch.Tensor | None, torch.Tensor | None]:
        return (None if self.a_mask is None else self.a_mask[i],
                None if self.a_feat is None else self.a_feat[i])


def epoch_inputs(batch: Graph, config: TrainingConfig) -> EpochInputs:
    """The ``EpochInputs`` of a stacked batch already on its device."""
    graphs = [batch.index(i) for i in range(batch.n_nodes.shape[0])]
    if not _resolve_dense_aggregation(config.aggregation, batch.n_pad, len(graphs)):
        return EpochInputs(batch, graphs, None, None)
    width = min(batch.n_pad, config.dim_embedding)
    a_mask = torch.stack([dense_adjacency(g, values="mask") for g in graphs])
    a_feat = (torch.stack([dense_adjacency(g, width=width) for g in graphs])
              if config.feature_mode == "adjacency" else None)
    return EpochInputs(batch, graphs, a_mask, a_feat)


def _params_tree(state: TrainState) -> Dict[str, Any]:
    return {**state.model.params(), "embed": state.embed}


def _run_epoch(state: TrainState, inputs: EpochInputs,
               generator: torch.Generator) -> torch.Tensor:
    """One epoch; returns its summed float32 loss as a 0-d tensor.
    ``per_graph``: an Adam step per graph, in dataset order.  ``batched``:
    one Adam step on the summed loss of every graph; on the dense path the
    forward runs on the whole batch at once, every aggregation one batched
    GEMM (``torch.bmm`` over the stacked operators)."""
    config = state.config
    state.model.train()
    params = _params_tree(state)
    if config.step_mode == "batched":
        if inputs.a_mask is not None:
            probs = _graph_probs(params, inputs.batch, config, generator,
                                 inputs.a_mask, inputs.a_feat)
        else:
            probs = torch.stack([_graph_probs(params, g, config, generator)
                                 for g in inputs.graphs])
        loss = torch.stack([_probs_loss(g, probs[i], config)
                            for i, g in enumerate(inputs.graphs)]).sum()
        state.optimizer.step(torch.autograd.grad(loss, state.optimizer.params))
        return loss.detach()
    losses = []
    for i, g in enumerate(inputs.graphs):
        loss = _graph_loss(params, g, config, generator, *inputs.dense(i))
        state.optimizer.step(torch.autograd.grad(loss, state.optimizer.params))
        losses.append(loss.detach())
    return torch.stack(losses).sum()


def make_epoch_fn(
    config: TrainingConfig, state: TrainState, max_chunk: int | None = None,
) -> Callable[..., np.ndarray]:
    """The JAX package's ``make_epoch_fn`` over a state held in place.

    ``epoch_fn(batch, generator, num_epochs=1)`` runs ``num_epochs`` epochs
    of ``config``'s steps on ``batch`` (a stacked ``Graph``, moved to the
    state's device), dropout drawn from ``generator``, with no early
    stopping; it updates ``state``'s parameters and Adam state in place and
    returns the epochs' summed losses, float32 ``[num_epochs]``.  The
    epochs run in chunks of at most ``max_chunk`` (default
    ``config.epochs_per_call``) through one ``ChunkRunner``: on one card an
    epoch captured once and replayed, the losses read once a chunk; on the
    CPU the same epochs eagerly.  The runner is built at the first call
    and again when ``batch`` or ``generator`` is another object
    (``epoch_fn.runner``).  As in the JAX package, ``epoch_fn.run_epoch``
    (``(inputs, generator) -> loss``: one eager epoch) and
    ``epoch_fn.epoch_inputs`` (``batch -> EpochInputs``, the operators
    built once a run) are the parts it runs.
    """
    run_state = dataclasses.replace(state, config=config)
    dev = state.embed.device
    K = max(1, int(max_chunk or config.epochs_per_call))
    bound: Dict[str, Any] = {}

    def run_epoch(inputs: EpochInputs, generator: torch.Generator) -> torch.Tensor:
        return _run_epoch(run_state, inputs, generator)

    def inputs_of(batch: Graph) -> EpochInputs:
        return epoch_inputs(batch.to(dev), config)

    def epoch_fn(batch: Graph, generator: torch.Generator, num_epochs: int = 1) -> np.ndarray:
        if bound.get("batch") is not batch or bound.get("generator") is not generator:
            inputs = inputs_of(batch)
            epoch_fn.runner = ChunkRunner(lambda: run_epoch(inputs, generator), [dev], K,
                                          optimizer=state.optimizer, generators=[generator])
            bound.update(batch=batch, generator=generator)
        return epoch_fn.runner.run_many(num_epochs)

    epoch_fn.runner = None
    epoch_fn.run_epoch = run_epoch
    epoch_fn.epoch_inputs = inputs_of
    return epoch_fn


def init_early_stop_state(
    params: Dict[str, Any],
    best_loss: float = float("inf"),
    prev_loss: float = float("inf"),
    epoch: int = 0,
) -> Dict[str, Any]:
    """The device state of the early stopping and best tracking: float32
    ``best_loss`` and ``prev_loss`` (infinity as float32's largest value,
    as in the JAX package), ``patience``, ``epoch``, ``stopped`` and
    ``best_params``, a copy of ``params`` (the JAX layout), which is what a
    run restores when no epoch improves, on the parameters' device."""
    dev = params["conv1"]["w"].device

    def f32(v: float) -> torch.Tensor:
        v = _F32_MAX if v == float("inf") else np.float32(v)
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return {
        "best_loss": f32(best_loss),
        "prev_loss": f32(prev_loss),
        "patience": torch.zeros((), dtype=torch.int64, device=dev),
        "epoch": torch.tensor(epoch, dtype=torch.int64, device=dev),
        "stopped": torch.zeros((), dtype=torch.bool, device=dev),
        "best_params": {k: ({n: t.detach().clone() for n, t in v.items()}
                            if isinstance(v, dict) else v.detach().clone())
                        for k, v in params.items()},
    }


def make_monitored_epoch_fn(
    state: TrainState, inputs: EpochInputs, es: Dict[str, Any],
    generator: torch.Generator,
) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """One epoch with the early stopping and best tracking of the JAX
    package's ``make_monitored_epoch_fn`` on the device, updating ``state``
    and ``es`` (``init_early_stop_state``) in place; returns ``(loss,
    stopped)`` as 0-d tensors, for ``train.chunks.ChunkRunner``.

      * patience grows when the loss is worse than the previous epoch's or
        moves by at most ``tolerance`` (from the second epoch on), and
        resets otherwise;
      * the epoch where patience reaches ``config.patience`` stops the run
        and is not eligible as best;
      * an epoch after the stop still computes, then puts the parameters,
        the Adam moments and the count back (``torch.where``), and its
        loss reads ``prev_loss``.
    """
    config = state.config
    tracked = state.optimizer.state_tensors()
    live_params = flatten_tree(_params_tree(state))
    best = flatten_tree(es["best_params"])

    def epoch() -> Tuple[torch.Tensor, torch.Tensor]:
        live = ~es["stopped"]
        saved = [t.detach().clone() for t in tracked]
        loss = _run_epoch(state, inputs, generator)
        with torch.no_grad():
            for t, old in zip(tracked, saved):
                torch.where(live, t, old, out=t)
            prev = es["prev_loss"]
            loss = torch.where(live, loss, prev)
            worse = (es["epoch"] > 0) & ((loss > prev)
                                         | (torch.abs(prev - loss) <= config.tolerance))
            patience = torch.where(live, torch.where(worse, es["patience"] + 1, 0),
                                   es["patience"])
            stop_now = live & (patience >= config.patience)
            is_best = live & ~stop_now & (loss < es["best_loss"])
            es["best_loss"].copy_(torch.where(is_best, loss, es["best_loss"]))
            es["prev_loss"].copy_(torch.where(live, loss, prev))
            es["patience"].copy_(patience)
            es["epoch"].add_(live.to(torch.int64))
            es["stopped"].logical_or_(stop_now)
            for k, b in best.items():
                b.copy_(torch.where(is_best, live_params[k], b))
        return loss, es["stopped"]

    return epoch


def train_model(
    dataset_batch: Graph,
    config: TrainingConfig,
    state: TrainState | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    device: str | torch.device | None = None,
    resume_from: str | None = None,
) -> Tuple[Dict[str, Any], float, int, torch.Tensor, List[float]]:
    """Epoch loop with early stopping, best-restore and checkpoints.

    ``dataset_batch`` is the stacked `Graph` from ``pad_graph_batch``; it is
    moved to the state's device.  Returns ``(params, best_loss,
    final_epoch, embed, history)`` with ``params`` the best epoch's, in the
    JAX layout.  ``resume_from`` continues from a checkpoint: its epoch + 1,
    its history (the best and previous losses taken from it, patience
    from 0) and its parameters as the best so far.
    """
    n_graphs = int(dataset_batch.n_nodes.shape[0])
    state = state or setup_train_state(
        config, steps_per_epoch=n_graphs if config.step_mode == "per_graph" else 1,
        device=device,
    )
    dev = state.embed.device
    inputs = epoch_inputs(dataset_batch.to(dev), config)
    generator = torch.Generator(device=dev).manual_seed(config.seed + 1)

    history: List[float] = []
    best_loss = prev_loss = np.float32(_F32_MAX)
    start_epoch = 0
    if resume_from is not None:
        params, opt_state, _, meta = load_checkpoint(
            resume_from, state.params(), state.opt_state()
        )
        state.load(params, opt_state)
        history = list(meta.get("loss_history") or [])
        start_epoch = int(meta.get("epoch", 0)) + 1
        if history:
            prev_loss, best_loss = np.float32(history[-1]), np.float32(min(history))
    es = init_early_stop_state(state.params(), float(best_loss), float(prev_loss), start_epoch)
    runner = ChunkRunner(make_monitored_epoch_fn(state, inputs, es, generator), [dev],
                         max(1, config.epochs_per_call), optimizer=state.optimizer,
                         generators=[generator])
    epoch, stop = start_epoch, False
    while epoch < config.number_epochs and not stop:
        chunk = min(runner.max_chunk, config.number_epochs - epoch)
        if config.save_directory:           # end the chunk at the next save epoch
            chunk = min(chunk, -epoch % config.save_frequency + 1)
        losses, stops = runner.run(chunk)
        for j in range(chunk):
            e, loss = epoch + j, float(losses[j])
            history.append(loss)
            stop = bool(stops[j])
            if config.save_directory and e % config.save_frequency == 0:
                save_checkpoint(
                    checkpoint_name(config.save_directory, e, loss),
                    params=state.params(), opt_state=state.opt_state(), epoch=e,
                    loss_history=history, config=config,
                )
            if callback is not None:
                callback(e, loss)
            if stop:
                break
        epoch += chunk

    best_params = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                       else v.clone()) for k, v in es["best_params"].items()}
    best_loss = float(es["best_loss"])
    if config.save_directory:
        save_checkpoint(
            checkpoint_name(config.save_directory), params=best_params,
            opt_state=state.opt_state(), epoch=len(history) - 1,
            loss_history=history, config=config,
        )
    return best_params, (float("inf") if best_loss >= _F32_MAX else best_loss), \
        len(history) - 1, best_params["embed"], history


def train_dataset(
    dataset: ProcessedDataset,
    model_name: str | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    device: str | torch.device | None = None,
    resume_from: str | None = None,
    **config_kwargs,
) -> Tuple[Dict[str, Any], float, int, torch.Tensor, List[float]]:
    """Train on a processed dataset; ``n_nodes`` (the feature width)
    defaults to the dataset's ``max_nodes``, and ``model_name`` is the
    checkpoints' name stem (None: no checkpoints)."""
    config = TrainingConfig(**{
        "n_nodes": dataset.config.max_nodes,
        "save_directory": model_name,
        **config_kwargs,
    })
    batch = pad_graph_batch([dataset.graphs[k] for k in sorted(dataset.graphs)])
    return train_model(batch, config, callback=callback, device=device,
                       resume_from=resume_from)


def train_from_files(
    dataset_paths: List[str],
    model_name: str | None = None,
    device: str | torch.device | None = None,
    **config_kwargs,
) -> Tuple[Dict[str, Any], float, int, torch.Tensor, List[float]]:
    """Train on several dataset files as one batch: the graph specs merged
    in file order, processed again with the first file's ``DataConfig``."""
    from gcn_maxcut_tpu_torch.data.io import load_dataset
    from gcn_maxcut_tpu_torch.data.process import process_graphs

    datasets = [load_dataset(p) for p in dataset_paths]
    specs = {}
    for ds in datasets:
        for _, spec in sorted(ds.specs.items()):
            specs[len(specs)] = spec
    merged = process_graphs(specs, datasets[0].config)
    return train_dataset(merged, model_name=model_name, device=device, **config_kwargs)


@torch.no_grad()
def evaluate_model(
    params: Dict[str, Any], dataset_batch: Graph, config: TrainingConfig
) -> Dict[str, float]:
    """Average no-grad STE loss over the dataset, whatever the training
    ``loss_mode``; ``-average_loss`` reads as the estimated average cut.
    Runs on the device that holds ``params``."""
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
