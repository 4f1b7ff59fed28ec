"""Profiling and per-step metrics: port of ``gcn_maxcut_tpu/utils/profiling.py``.

  * ``trace(logdir)``: a ``torch.profiler`` trace of the region (the CPU,
    and the card where there is one), written into ``logdir`` as a Chrome
    trace (``*.pt.trace.json``, for Perfetto or TensorBoard), where the JAX
    one runs ``jax.profiler``;
  * ``annotate(name)``: a named region in that timeline
    (``torch.profiler.record_function``, the JAX ``TraceAnnotation``);
  * ``MetricsLogger`` (``train --metrics``): an append-only JSONL stream
    plus the in-memory history; each record holds the step, the wall-clock
    time, the host-clock seconds since the previous record and the given
    metrics.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the region into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ):
        yield


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class MetricsLogger:
    """Append-only JSONL metrics stream + in-memory history."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self.history: list[Dict[str, Any]] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t_last = time.perf_counter()

    def log(self, step: int, **metrics: Any) -> Dict[str, Any]:
        now = time.perf_counter()
        rec = {
            "step": step,
            "time": time.time(),
            "step_time_s": now - self._t_last,
            **{
                k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                for k, v in metrics.items()
            },
        }
        self._t_last = now
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def edges_per_s(self, n_edges: int) -> Optional[float]:
        if not self.history:
            return None
        dt = self.history[-1]["step_time_s"]
        return n_edges / dt if dt > 0 else None
