"""Straight-through estimator ops: terminal pinning and hard argmax.

Port of ``gcn_maxcut_tpu/ops/ste.py``.  ``detach`` plays the role of
``stop_gradient``: forward(x) = hard(x) and d forward / d x = I.
"""

from __future__ import annotations

import torch


def pin_terminals(h: torch.Tensor, num_terminals: int | None = None) -> torch.Tensor:
    """Pin rows ``0..t-1`` of ``h`` [n, k] to one-hot ``e_0..e_{t-1}`` with
    identity gradient on every row (``t`` defaults to ``k``)."""
    n, k = h.shape
    t = k if num_terminals is None else num_terminals
    row = torch.arange(n, device=h.device)[:, None]
    col = torch.arange(k, device=h.device)[None, :]
    onehot_rows = (row == col).to(h.dtype)
    is_terminal = (row < t).to(h.dtype)
    hard = is_terminal * onehot_rows + (1.0 - is_terminal) * h
    return (hard - h).detach() + h


def ste_argmax_onehot(h: torch.Tensor) -> torch.Tensor:
    """Row-wise hard argmax one-hot with straight-through gradient; ties go
    to the lowest index, as ``torch.argmax`` and ``jnp.argmax`` resolve them."""
    idx = torch.argmax(h, dim=-1)
    hard = torch.nn.functional.one_hot(idx, h.shape[-1]).to(h.dtype)
    return (hard - h).detach() + h
