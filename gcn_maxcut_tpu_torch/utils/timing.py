"""Wall-clock timing of phases and steps: port of ``Timer`` and
``PhaseTimer`` of ``gcn_maxcut_tpu/utils/timing.py``.

Where the JAX ``Timer`` calls ``jax.block_until_ready`` on its ``sync``
argument, this one synchronizes the CUDA device of every tensor in it (a
tensor, or nested lists, tuples and dicts of them); CPU tensors need no
wait.  ``scan_timeit`` and ``scan_timeit_stats`` are not ported: they work
around a TPU runtime whose ``block_until_ready`` returned early, and CUDA
events time the card here.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch


def _cuda_devices(tree: Any) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree)) if tree else set()
    return set()


class Timer:
    """Context manager measuring wall time; ``.elapsed`` in seconds, read
    after the devices of ``sync``'s tensors finished their queued work."""

    def __init__(self, sync: Any = None):
        self._sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for dev in _cuda_devices(self._sync):
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._start
        return False


class PhaseTimer:
    """Accumulates named phase durations (generation/processing/training...)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self._start = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.phases[name] = timer.phases.get(name, 0.0) + (
                    time.perf_counter() - self._start)
                return False

        return _Ctx()

    def summary(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v:.2f}s" for k, v in self.phases.items()]
        lines.append(f"total: {total:.2f}s")
        return "\n".join(lines)
