"""Migrating a reference PyTorch checkpoint to the port's trainer and back
(port of ``examples/torch_migration.py``).

A user of the reference (``MJavaadAkhtar/GCN-max-cut``) has ``.pth`` files
written by its ``train_model`` (``Training/TrainingNeural.py:447-482``):

  1. load the checkpoint: the DGL GraphConv weights map one to one, the
     torch Adam moments graft into the port's Adam state, the pickled
     config is translated (no reference code needs to be installed);
  2. continue training for 5 epochs on the card from where the reference
     stopped;
  3. export back to the reference's ``torch.save`` layout, beside the input
     as ``<name>_continued.pth``.

Unpickling a ``.pth`` runs code: load trusted files only.  The CLI does the
conversion alone:

    python -m gcn_maxcut_tpu_torch convert final_mymodel.pth migrated.npz
    python -m gcn_maxcut_tpu_torch convert final_mymodel.npz exported.pth

Usage:

    python -m gcn_maxcut_tpu_torch.examples.torch_migration final_model.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict

import torch

RESUME_EPOCHS = 5


def main(path: str, device: str | torch.device | None = None) -> Dict[str, Any]:
    """Returns the resumed epochs' losses and the exported path."""
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state, train_model
    from gcn_maxcut_tpu_torch.train.torch_compat import (
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    # 1. the checkpoint's own config, then weights and Adam moments grafted
    # into a live train state
    _, _, meta = load_torch_checkpoint(path)
    cfg: TrainingConfig = meta["config"]
    print(f"loaded {path}: epoch {meta['epoch']}, {len(meta['loss_history'])} loss records, "
          f"model {cfg.dim_embedding}->{cfg.hidden_dim}->{cfg.number_classes}")
    state = setup_train_state(cfg, device=device)
    params, opt_state, meta = load_torch_checkpoint(path, optimizer=state,
                                                    params_template=state.params())
    if "embed" not in params:
        params["embed"] = state.params()["embed"]
    state.load(params, opt_state or state.opt_state())

    # 2. resume: every epoch runs (no early stop, no checkpoints)
    specs = [generate_graph(n=min(cfg.n_nodes, 500), d=6, graph_type="reg", seed=i)
             for i in range(4)]
    ds = process_graphs(specs, DataConfig(max_nodes=cfg.n_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    run = dataclasses.replace(cfg, number_epochs=RESUME_EPOCHS, save_directory=None,
                              patience=max(cfg.patience, RESUME_EPOCHS))
    _, _, _, _, losses = train_model(batch, run, state=state)
    print(f"resumed {RESUME_EPOCHS} epochs on {state.embed.device}, losses:", losses)

    # 3. export the state after the last epoch for the reference's tooling
    out = save_torch_checkpoint(
        path.replace(".pth", "_continued.pth"), state.params(),
        epoch=meta["epoch"] + RESUME_EPOCHS,
        loss_history=meta["loss_history"] + [losses[-1]],
        config=cfg, opt_state=state.opt_state(),
    )
    print("exported", out)
    return {"losses": losses, "exported": out}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    a = p.parse_args()
    main(a.path, a.device)
