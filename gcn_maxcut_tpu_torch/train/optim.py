"""Adam written out on tensors, in the order ``optax.adam`` computes it.

Every trainer of the port uses it: the recipe loop (``train/loop.py``) and
the QUBO loop (``train/qubo_loop.py``) with torch's default
hyperparameters, and the giant trainers
(``bench/giant_demo.py``), whose first moment may be stored in bfloat16
(``mu_dtype``) — which ``torch.optim.Adam`` cannot do.  As in optax, the
new first moment is computed in float32 from the stored one, the update
uses that float32 value, and only the stored copy is cast:

    mu  = b1·mu_stored + (1 − b1)·g          nu = b2·nu + (1 − b2)·g²
    p  += −lr · (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t)) + eps)
    mu_stored = mu.to(mu_dtype)

with eps outside the square root.  Parameters are updated in place.

``lr`` may be a schedule, a function of the update count; each update uses
its value at the count before the update (optax's ``scale_by_schedule``
reads its count, then increments it), so the first update uses lr(0).
``cosine_decay_schedule`` is optax's, computed in float32 as optax does.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def cosine_decay_schedule(
    init_value: float, decay_steps: int, alpha: float = 0.0
) -> Callable[[int], float]:
    """lr(t) = init·((1 − α)·½(1 + cos(π·min(t, T)/T)) + α), T = decay_steps."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        t = f32(min(count, decay_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps)))
        return float(f32(init_value) * ((f32(1) - f32(alpha)) * decay + f32(alpha)))

    return schedule


class Adam:
    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float | Callable[[int], float] = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        mu_dtype: torch.dtype | None = None,
    ):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1.0 - self.b1) * g + self.b1 * self.mu[i]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[i]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -lr)
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu
