"""Checkpointing: parameters, optimizer state and history as ``.npz``.

Port of ``gcn_maxcut_tpu/train/checkpoint.py`` in the same flattened layout,
so a checkpoint either package writes loads in the other: one array per
leaf of a nested dict, named ``params:<path>``, ``opt:<path>`` and
``embed:<path>`` with the path's keys joined by ``/``, and ``_meta``, the
JSON bytes of ``epoch``, ``loss_history`` and the ``TrainingConfig``.
bfloat16 leaves are stored as float32 and cast back to the template's
dtype on load.  The optimizer state's paths are the JAX package's optax
Adam state (``TrainState.opt_state`` builds them).  Names follow the
reference: ``epoch_{e}_loss_{l:.4f}_{name}`` and ``final_{name}``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.train.config import TrainingConfig


def checkpoint_name(
    name: str, epoch: int | None = None, loss: float | None = None
) -> str:
    """``epoch_{e}_loss_{l:.4f}_{name}`` or ``final_{name}``; ``name`` may
    include a directory, the prefix goes on its last part."""
    p = Path(name)
    if epoch is None:
        return str(p.with_name(f"final_{p.name}"))
    return str(p.with_name(f"epoch_{epoch}_loss_{loss:.4f}_{p.name}"))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves of a nested dict by their ``/``-joined key paths (a bare
    tensor is the one leaf at path "")."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        flat.update(flatten_tree(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(template: Any, leaves: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    if not isinstance(template, dict):
        return leaves[prefix]
    return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()}


def save_checkpoint(
    path: str | Path,
    *,
    params: Any,
    opt_state: Any = None,
    epoch: int = 0,
    loss_history: list[float] | None = None,
    embed: Any = None,
    config: TrainingConfig | None = None,
) -> Path:
    """Write a checkpoint; returns the path (``.npz`` appended if missing)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    arrays: Dict[str, np.ndarray] = {}
    for prefix, tree in (("params", params), ("opt", opt_state), ("embed", embed)):
        if tree is None:
            continue
        for k, v in flatten_tree(tree).items():
            v = v.detach().cpu()
            arrays[f"{prefix}:{k}"] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    meta = {
        "epoch": int(epoch),
        "loss_history": [float(x) for x in (loss_history or [])],
        "config": None if config is None else config.to_json(),
        "params_treedef": None,
    }
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_checkpoint(
    path: str | Path,
    params_template: Any,
    opt_state_template: Any = None,
    embed_template: Any = None,
) -> Tuple[Any, Any, Any, Dict[str, Any]]:
    """Load into the structure of the templates: each leaf must have the
    template's shape, and comes back in its dtype and on its device.

    Returns ``(params, opt_state, embed, meta)``; ``meta`` holds ``epoch``,
    ``loss_history`` and the parsed ``config`` (or None).
    """
    path = Path(path)
    if not path.exists() and path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode())

        def restore(prefix: str, template: Any) -> Any:
            if template is None:
                return None
            leaves = {}
            for k, tmpl in flatten_tree(template).items():
                arr = data[f"{prefix}:{k}"]
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(
                        f"checkpoint leaf {prefix}:{k} shape {arr.shape} != "
                        f"template {tuple(tmpl.shape)}"
                    )
                leaves[k] = torch.from_numpy(np.array(arr)).to(tmpl.device, tmpl.dtype)
            return _unflatten_like(template, leaves)

        params = restore("params", params_template)
        opt_state = restore("opt", opt_state_template)
        embed = restore("embed", embed_template)
    if meta.get("config"):
        meta["config"] = TrainingConfig.from_json(meta["config"])
    return params, opt_state, embed, meta
