"""Per-step metrics: port of ``MetricsLogger`` of
``gcn_maxcut_tpu/utils/profiling.py`` (``train --metrics``).

An append-only JSONL stream plus the in-memory history; each record holds
the step, the wall-clock time, the host-clock seconds since the previous
record and the given metrics.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


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
