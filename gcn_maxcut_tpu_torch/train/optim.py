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

``lr`` may be a constant or ``cosine_decay_schedule``'s schedule, a
function of the update count; each update uses its value at the count
before the update (optax's ``scale_by_schedule`` reads its count, then
increments it), so the first update uses lr(0).  ``cosine_decay_schedule``
is optax's, computed in float32 as optax does.

The step can be captured in a CUDA graph (``train/chunks.py``): the count
is a device tensor, the moments are updated in place, and the rate and the
bias corrections are read at the count from one small device table built
once, up to the count from which every later value is the same (the count
is clamped there).  The table holds what the step written with Python
numbers used, so a captured step is that step bit for bit: the float32
rate, and ``1 − b^t`` taken in double as PyTorch divides by it.  On the
CPU ``x / b`` is a float32 division by float32(b); PyTorch's CUDA kernel
multiplies by the float32 of 1 / b taken in double instead (PyTorch 2.11),
so on the card the table holds those reciprocals and the step multiplies.

The step itself is ``ops/adam.py``'s: on a card one launch of
``csrc/adam.cu`` for all the card's leaves and one for the count, the same
bits as the plain step, which the CPU runs.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch.ops import adam


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

    schedule.decay_steps = decay_steps      # constant from this count on
    return schedule


@functools.lru_cache(maxsize=None)
def _bias_corrections(b: float) -> np.ndarray:
    """1 − b^t in double for t = 0, 1, ... up to the first t where its
    float32 is 1 (entry 0, never read, is 1)."""
    out = [1.0]
    while len(out) == 1 or np.float32(out[-1]) != np.float32(1):
        out.append(1.0 - b ** len(out))
    return np.array(out, dtype=np.float64)


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
        dev = self.params[0].device
        self._count = torch.zeros(1, dtype=torch.int64, device=dev)
        if callable(lr) and not hasattr(lr, "decay_steps"):
            raise ValueError("lr must be a number or cosine_decay_schedule's schedule")
        bcs = [_bias_corrections(b) for b in (b1, b2)]
        last = max(len(bcs[0]), len(bcs[1]), getattr(lr, "decay_steps", 0) + 1) - 1
        if callable(lr):            # constant from decay_steps on
            rate = -np.array([lr(t) for t in range(lr.decay_steps + 1)], dtype=np.float32)
            rate = np.pad(rate, (0, last + 1 - len(rate)), mode="edge")
        else:
            rate = np.full(last + 1, -np.float32(lr), dtype=np.float32)
        # the bias corrections after the update: entry t is 1 − b^(t + 1),
        # or on the card its reciprocal, as x / b rounds on each device
        self._reciprocal = dev.type == "cuda"
        bcs = [np.pad(bc, (0, last + 2 - len(bc)), constant_values=1)[1:] for bc in bcs]
        bcs = [(1.0 / bc if self._reciprocal else bc).astype(np.float32) for bc in bcs]
        self._last = last
        # [3, last + 1], column t for an update at count t: −lr(t), then
        # the two bias corrections
        self._tables = torch.from_numpy(np.stack([rate, *bcs])).to(dev)
        # each other card of a mesh: its count slot and tables (ops/adam.py)
        self._side = adam.side_state(self.params, self._count, self._tables)
        self.nonfinite: torch.Tensor | None = None   # set by train.chunks.checked

    @property
    def count(self) -> int:
        """Updates done (a host read of the device count)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    @torch.no_grad()
    def load(self, count: int, mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]) -> None:
        """Set the count and copy the moments into place (a captured step
        keeps reading the same buffers)."""
        self.count = count
        for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
            dst.copy_(src)

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a step writes: parameters, moments and the count."""
        return [*self.params, *self.mu, *self.nu, self._count]

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every leaf by its gradient (``ops/adam.step``)."""
        adam.step(self, grads)
