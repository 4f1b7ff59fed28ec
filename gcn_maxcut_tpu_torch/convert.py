"""Parameters from the JAX package into the port's layout.

Both parameter trees the port trains share one shape:
``{"conv1": {"w", "b"}, "conv2": {"w", "b"}, "embed"}`` — the recipe's
(``gcn_maxcut_tpu/train/loop.py`` ``setup_train_state``) and the packed
giant trainer's (``gcn_maxcut_tpu/bench/giant_demo.py``, whose ``embed`` is
the packed [m, r·emb] table).  Weight matrices keep the JAX ``[in, out]``
layout; nothing is transposed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gcn_maxcut_tpu_torch.device import resolve_device


def params_from_jax(tree: Any, device: str | torch.device | None = None) -> Any:
    """Map a nested dict of arrays (numpy, or anything ``np.asarray`` takes)
    onto the same nested dict of float32 torch tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(dev)

    return conv(tree)
