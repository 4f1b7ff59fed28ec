"""The legacy single-graph QUBO (PI-GNN) training loop.

Port of ``gcn_maxcut_tpu/train/qubo_loop.py``: the sigmoid GCN
(``models.gcn.gcn_dev_apply``) on one graph with embedding-table features,
the QUBO loss xᵀQx (``objectives.qubo``), one Adam step an epoch, the
probability-threshold projection, the best bitstring tracked by its hard
QUBO loss, and the tolerance/patience early stopping of the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.models.gcn import embedding_init, gcn_dev_apply, gcn_dev_init
from gcn_maxcut_tpu_torch.objectives.qubo import qubo_loss
from gcn_maxcut_tpu_torch.train.optim import Adam

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class QuboConfig:
    """The legacy ``gnn_hypers`` settings, as in the JAX package."""

    dim_embedding: int = 80
    hidden_dim: int = 40
    learning_rate: float = 1e-4
    number_epochs: int = 100_000
    tolerance: float = 1e-4
    patience: int = 100
    prob_threshold: float = 0.5
    seed: int = 0


def run_gnn_training(
    g: Graph,
    config: QuboConfig = QuboConfig(),
    device: str | torch.device | None = None,
    params: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Train the sigmoid GCN on one graph's QUBO; returns (params, results).

    ``params``: initial ``{"conv1", "conv2", "embed": [n_pad, emb]}`` in
    the JAX layout (``convert.params_from_jax``); by default drawn from
    ``config.seed``.  The results hold the best bitstring (int32 [n_pad])
    and its loss and cut, the epoch count, the final loss, the loss history
    and the runtime.  Each epoch's bitstring is the threshold of the
    probabilities its step was taken on.
    """
    dev = resolve_device(device)
    g = g.to(dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        params = gcn_dev_init(config.dim_embedding, config.hidden_dim, 1,
                              generator=gen, device=dev)
        params["embed"] = embedding_init(g.n_pad, config.dim_embedding, gen, dev)
    params = {k: ({n: t.to(dev).clone() for n, t in v.items()} if isinstance(v, dict)
                  else v.to(dev).clone())
              for k, v in params.items()}
    leaves = [params["conv1"]["w"], params["conv1"]["b"],
              params["conv2"]["w"], params["conv2"]["b"], params["embed"]]
    for t in leaves:
        t.requires_grad_(True)
    optimizer = Adam(leaves, config.learning_rate)

    best_loss = float("inf")
    best_bitstring = None
    prev_loss = float("inf")
    patience_count = 0
    history: List[float] = []
    t0 = time.time()
    epoch = 0
    for epoch in range(config.number_epochs):
        probs = gcn_dev_apply(params, g, params["embed"])[:, 0]
        loss = qubo_loss(g, probs)
        optimizer.step(torch.autograd.grad(loss, leaves))
        bitstring = (probs.detach() >= config.prob_threshold).to(torch.int32)
        hard_loss = qubo_loss(g, bitstring.to(torch.float32))
        loss_f, hard_f = torch.stack([loss.detach(), hard_loss]).tolist()
        history.append(loss_f)
        if hard_f < best_loss:
            best_loss = hard_f
            best_bitstring = bitstring
        if abs(loss_f - prev_loss) <= config.tolerance or loss_f > prev_loss:
            patience_count += 1
            if patience_count >= config.patience:
                logger.info("qubo early stopping at epoch %d", epoch)
                break
        else:
            patience_count = 0
        prev_loss = loss_f

    runtime = time.time() - t0
    results = {
        "best_bitstring": best_bitstring,
        "best_loss": best_loss,            # = -cut of the best bitstring
        "best_cut": -best_loss,
        "final_loss": history[-1] if history else None,
        "epochs": epoch + 1,
        "loss_history": history,
        "runtime_s": runtime,
    }
    out = {k: ({n: t.detach() for n, t in v.items()} if isinstance(v, dict) else v.detach())
           for k, v in params.items()}
    return out, results
