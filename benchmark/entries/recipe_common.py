"""What the two recipe cells share: the training set as the program takes it,
the initial weights, the training configuration, the window over
``train_model``'s epochs, and the readings of the first epochs that the
reference follows."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark import generator, harness

LEAF_OF = (("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b"))


def training_graphs(cell: harness.Cell) -> List[generator.GraphData]:
    c = cell.config
    return generator.regular_graphs(cell.seed, generator.GRAPHS,
                                    [c["nodes"]] * cell.traffic["train_graphs"], c["degree"])


def program_graphs(graphs: List[generator.GraphData], config: Dict[str, Any]) -> list:
    """The graphs as the program's data path makes them (``process_graphs``:
    one shared padding), in order."""
    from gcn_maxcut_tpu_torch.data.generate import GraphSpec
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs

    terminals = list(range(config["terminals"]))
    ds = process_graphs([GraphSpec(g.n, g.edges, terminals, degree=g.d) for g in graphs],
                        DataConfig(max_nodes=config["pad_to"]))
    return [ds.graphs[k] for k in sorted(ds.graphs)]


def program_batch(graphs: List[generator.GraphData], config: Dict[str, Any]):
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch

    return pad_graph_batch(program_graphs(graphs, config))


def init_weights(seed: int, config: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Glorot-uniform weights and zero biases (the published GraphConv
    init), drawn on the device from the seed; the embedding table, unused
    with adjacency features, is zeros."""
    gen = torch.Generator(device=device).manual_seed(
        generator.torch_seed(generator.rng(seed, generator.WEIGHTS)))
    dims = [(config["in_features"], config["hidden"]), (config["hidden"], config["classes"])]
    out: Dict[str, Any] = {}
    for i, (a, b) in enumerate(dims, 1):
        lim = math.sqrt(6.0 / (a + b))
        w = torch.rand((a, b), generator=gen, device=device) * (2 * lim) - lim
        out[f"conv{i}"] = {"w": w, "b": torch.zeros(b, device=device)}
    out["embed"] = torch.zeros((config["pad_to"], config["in_features"]), device=device)
    return out


def training_config(config: Dict[str, Any], **kw):
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig

    return TrainingConfig(
        n_nodes=config["pad_to"], dim_embedding=config["in_features"],
        hidden_dim=config["hidden"], number_classes=config["classes"],
        learning_rate=config["learning_rate"], tolerance=config["tolerance"],
        epochs_per_call=config["epochs_per_call"], **kw)


class WindowClosed(Exception):
    """Raised by the epoch callback to end ``train_model`` at the window's
    close."""


class FirstEpochs:
    """``train_model``'s callback: records the first ``check`` epochs'
    losses and the parameters' change after ``check`` epochs, then hands the
    epoch to ``then``; the first step's gradient norms (``grad``) are read
    from the optimizer's state after that step."""

    def __init__(self, state, params0: Dict[str, Any], check: int, then=None):
        self.state, self.params0, self.check, self.then = state, params0, check, then
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        by_id = {id(p): k for k, p in self.leaves().items()}
        harness.watch_first_step(state.optimizer, [by_id[id(p)] for p in state.optimizer.params],
                                 self.grad)

    def leaves(self) -> Dict[str, torch.Tensor]:
        model = self.state.model
        return {f"{a}.{b}": getattr(getattr(model, a), b) for a, b in LEAF_OF}

    @torch.no_grad()
    def __call__(self, epoch: int, loss: float) -> None:
        if len(self.losses) < self.check:
            self.losses.append(loss)
        if epoch == self.check - 1:
            self.change = {k: float((p.double() - self.params0[k.split(".")[0]][k.split(".")[1]]
                                     .double()).norm()) for k, p in self.leaves().items()}
        if self.then is not None:
            self.then(epoch)


class EpochWindow:
    """Opens the window at the callback of epoch ``warmup - 1`` and closes
    it at the first callback after ``seconds`` (or, traced, after
    ``trace_epochs`` epochs) by raising ``WindowClosed``."""

    def __init__(self, warmup: int, seconds: float, trace_epochs: int | None, device: str):
        self.warmup, self.seconds, self.trace_epochs = warmup, seconds, trace_epochs
        self.tracer = harness.TracedWindow(device) if trace_epochs else None
        self.start = self.end = None
        self.epochs = 0
        self.trace = None

    def __call__(self, epoch: int) -> None:
        if epoch == self.warmup - 1:
            if self.tracer is not None:
                self.tracer.start()
            self.start = harness.now()
            return
        if self.start is None:
            return
        self.epochs = epoch - (self.warmup - 1)
        if self.tracer is not None:
            if self.epochs >= self.trace_epochs:
                self.trace = self.tracer.stop()
                self.end = harness.now()
                raise WindowClosed
        elif harness.now() - self.start >= self.seconds:
            self.end = harness.now()
            raise WindowClosed


def run_training(cell: harness.Cell, graphs, batch, params0, config, then=None):
    """``train_model`` on ``batch`` from ``params0``; returns (the trained
    parameters or None where ``then`` closed the window, the readings)."""
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state, train_model

    state = setup_train_state(config, steps_per_epoch=len(graphs), params=params0,
                              device=cell.device)
    first = FirstEpochs(state, params0, cell.traffic["check_epochs"], then)
    try:
        trained = train_model(batch, config, state=state, callback=first)[0]
    except WindowClosed:
        trained = None
    return trained, first


def reference_graphs(ref, graphs, config: Dict[str, Any], device: str) -> list:
    return [ref.DenseGraph(g.n, g.edges, config["in_features"], device) for g in graphs]


def training_values(ref, graphs, params0, config: Dict[str, Any], device: str, check: int,
                    prog: Dict[str, Any] | None) -> Dict[str, float]:
    """The training numbers compared: the first ``check`` epochs' losses,
    the first step's gradient and the change after ``check`` epochs, each
    against the reference's.  ``prog`` None: the
    control, the reference in TF32, stands in the program's place."""
    dense = reference_graphs(ref, graphs, config, device)
    want = ref.train(params0, dense, config, epochs=check)
    if prog is None:
        prog = ref.train(params0, dense, config, epochs=check, tf32=True)
        prog["grad"] = prog["first_grad"]
    kept = harness.kept_leaves(want["first_grad"])
    return {
        "loss_gap": harness.loss_gap(prog["losses"], want["losses"]),
        "grad_gap": harness.leaf_gap(prog["grad"], want["first_grad"], kept),
        "change_gap": harness.leaf_gap(prog["change"], want["change"], kept),
    }
