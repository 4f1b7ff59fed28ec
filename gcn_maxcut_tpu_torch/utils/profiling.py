"""Profiling, the program's spans and counters, and per-step metrics: port of
``gcn_maxcut_tpu/utils/profiling.py``.

  * ``trace(logdir)``: a ``torch.profiler`` trace of the region (the CPU,
    and the card where there is one), written into ``logdir`` as a Chrome
    trace (``*.pt.trace.json``, for Perfetto or TensorBoard), where the JAX
    one runs ``jax.profiler``; the region starts from empty totals
    (``reset``);
  * ``span(name)`` (also ``annotate``, the JAX package's name): a named
    region of the program.  While a ``torch.profiler`` session is active,
    and only then, it is a ``record_function`` range in that session's
    trace, on the clock of the device activity beside it, and its host
    seconds add to ``span_totals()[name]``: ``count``, ``total_s`` and
    ``self_s`` (the total less the time its child spans cover).  With no
    session it checks one flag and records nothing;
  * ``count(name, n=1)``: adds ``n`` to ``counts()[name]``, only while a
    session is active (``counting()``);
  * ``reset()``: empties the span totals and the counters;
  * ``MetricsLogger`` (``train --metrics``): an append-only JSONL stream
    plus the in-memory history; each record holds the step, the wall-clock
    time, the host-clock seconds since the previous record and the given
    metrics.

A span neither reads the device nor waits for it, so its seconds are the
host's.  None is opened inside a step that a CUDA graph captures: a replay
runs none of the step's Python.  Spans and counters are recorded from one
thread.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# span name -> [count, total seconds, self seconds]
_TOTALS: Dict[str, List[float]] = {}
_COUNTS: Dict[str, int] = {}
# the recording spans now open, innermost last: [start, children's seconds]
_OPEN: List[List[float]] = []
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the region into ``logdir``, from empty totals."""
    reset()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ):
        yield


class _Span:
    """A span opened while a profiler session is active."""

    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self) -> "_Span":
        self.range.__enter__()
        _OPEN.append([time.perf_counter(), 0.0])
        return self

    def __exit__(self, *exc) -> None:
        start, children = _OPEN.pop()
        seconds = time.perf_counter() - start
        self.range.__exit__(*exc)
        tally = _TOTALS.setdefault(self.name, [0, 0.0, 0.0])
        tally[0] += 1
        tally[1] += seconds
        tally[2] += seconds - children
        if _OPEN:
            _OPEN[-1][1] += seconds


def span(name: str):
    """Named region of the program (see the module docstring)."""
    return _Span(name) if _autograd_profiler._is_profiler_enabled else _OFF


annotate = span


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler session is active."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counting() -> bool:
    """Whether ``count`` adds now (a profiler session is active): a caller
    reads the device for a counter only then."""
    return _autograd_profiler._is_profiler_enabled


def span_totals() -> Dict[str, Dict[str, float]]:
    """Each span recorded since the last ``reset``: ``{name: {"count",
    "total_s", "self_s"}}``."""
    return {k: {"count": int(c), "total_s": t, "self_s": s} for k, (c, t, s) in _TOTALS.items()}


def counts() -> Dict[str, int]:
    """Each counter's sum since the last ``reset``."""
    return dict(_COUNTS)


def reset() -> None:
    """Empties the span totals and the counters."""
    _TOTALS.clear()
    _COUNTS.clear()


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
