"""What every cell shares: finding a cell's files by name, the check for JAX,
the traced window and its reduction, the checks beside their limits, and
the result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix.  Each is a file of its own, found by name:
``configs/<config>.json`` (as BENCHMARK.json lists it), the plain
reference ``reference/<config>.py``, ``traffic/<traffic>.json``, whose
``entry`` names the module of ``entries/`` that binds the mix to the
program's entry points, the limits of its checks ``limits/<workload>.json``,
and one reader a per-layer metric, ``metrics/<metric>.py``.  A later cell,
mix or metric is new files and new entries, with no edit here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

# Top-level module names that may not be loaded in a run, compared whole:
# gcn_maxcut_tpu_torch (the program) begins with gcn_maxcut_tpu (the JAX
# package) and is allowed.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gcn_maxcut_tpu"})
WINDOW_SPAN = "bench.window"
SHORT_GAP_US = 10.0          # idle gaps shorter than this are launch gaps


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The top-level names among module names ``names`` that are JAX or the
    JAX package."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> Any:
    """A module of the benchmark found by file name (names may hold dots)."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One run's cell: its entries and files, and the run's arguments."""

    workload: str
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    control: bool = False
    device: str = "cuda"

    def entry(self) -> Any:
        return importlib.import_module(f"benchmark.entries.{self.traffic['entry']}")

    def reference(self) -> Any:
        return load_module(BENCH / "reference" / f"{self.config_name}.py")


def _in_cell(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, seed: int, seconds: float, trace: bool, control: bool = False,
              device: str = "cuda", bench: Dict[str, Any] | None = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json (or of ``bench``)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        workload=workload,
        config_name=w["config"],
        config=load_json(ROOT / conf["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, workload)],
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        seed=int(seed), seconds=float(seconds), trace=bool(trace), control=bool(control),
        device=device,
    )


# ---- the checks ------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return isinstance(self.value, (int, float)) and math.isfinite(self.value) \
            and self.value <= self.limit


def checks(limits: Dict[str, float], values: Dict[str, float]) -> List[Check]:
    """One ``Check`` for every limit; a number the run did not give reads NaN
    and fails."""
    return [Check(k, float(values.get(k, float("nan"))), float(v)) for k, v in limits.items()]


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def watch_first_step(optimizer, names: List[str], out: Dict[str, float]) -> None:
    """Read the first gradient as ``optimizer`` (the program's ``Adam``) gets
    it, from its state after one step: ‖√(ν / (1 − b2))‖ of each leaf,
    into ``out`` by ``names``.  The watch wraps the first ``step`` call only
    (an eager one, before any capture) and then removes itself."""
    import torch

    def step(grads):
        type(optimizer).step(optimizer, grads)
        del optimizer.step
        with torch.no_grad():
            out.update({n: float(torch.sqrt(v.double() / (1 - optimizer.b2)).norm())
                        for n, v in zip(names, optimizer.nu)})

    optimizer.step = step


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The worst step's relative gap between the program's loss and the
    reference's; a missing step reads infinite."""
    if len(prog) < len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


# ---- the device ------------------------------------------------------------

def free_device() -> None:
    """Return freed memory to the device (after the program's state is
    dropped, before the reference runs)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def synchronize(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class TracedWindow:
    """``torch.profiler`` (host and device) over a window opened by
    ``start`` and closed by ``stop``, which returns ``reduce_trace``'s
    summary.  The window is a span of its own, so its ends lie on the
    trace's clock."""

    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self.span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        synchronize(self.device)
        acts = [ProfilerActivity.CPU]
        if str(self.device).startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, acc_events=True)
        self.prof.start()
        self.span = record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self) -> Dict[str, Any]:
        synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        events = self.prof.events()
        self.prof = None
        return reduce_trace(events)


def _merge(intervals: List[tuple]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str, width: int = 100) -> str:
    name = " ".join(str(name).split())
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce_trace(events: Iterable[Any]) -> Dict[str, Any]:
    """The window's device activity from one trace's own intervals.

    ``events``: ``torch.profiler``'s events (``name``, ``device_type``,
    ``time_range`` in microseconds).  Device events are kernels, copies and
    sets; host events are everything else on the CPU (ops, runtime calls,
    spans).  Returns ``window_s``, ``busy_s`` (the union of device intervals
    inside the window), ``kernels`` (launches in it), ``kernel_s`` (device
    seconds by kernel name), ``runtime`` (host runtime calls by name), and
    the breakdown: ``device_ops`` (the 10 that took most device time) and
    ``idle_gaps`` (idle time by what the host was doing at each gap's
    middle, the innermost host event; gaps under 10 us are launch gaps)."""
    events = list(events)
    host, device = [], []
    window = None
    for e in events:
        kind = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.name == WINDOW_SPAN:
            if kind == "CPU":
                window = (start, end)
            continue
        if getattr(e, "is_user_annotation", False) and kind != "CPU":
            continue
        (device if kind == "CUDA" else host).append((start, end, e.name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    kernel_s: Dict[str, float] = {}
    op_s: Dict[str, float] = {}
    kernels = 0
    for s, e, n in inside:
        op_s[n] = op_s.get(n, 0.0) + (e - s) / 1e6
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            kernels += 1
            kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e6
    runtime: Dict[str, int] = {}
    for s, e, n in host:
        if w0 <= s <= w1 and n.startswith("cuda"):
            runtime[n] = runtime.get(n, 0) + 1
    # idle gaps, each named by the innermost host event covering its middle
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host_sorted = sorted((s, e, n) for s, e, n in host if e > w0 and s < w1)
    idle: Dict[str, float] = {}
    active: List[tuple] = []
    j = 0
    for s, e in gaps:
        if e - s < SHORT_GAP_US:
            label = f"launch gaps (<{SHORT_GAP_US:g} us)"
        else:
            mid = (s + e) / 2
            while j < len(host_sorted) and host_sorted[j][0] <= mid:
                active.append(host_sorted[j])
                j += 1
            active = [a for a in active if a[1] >= mid]
            label = ("host: " + _short(max(active)[2])) if active else "host: nothing traced"
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    top = lambda d: [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "kernel_s": kernel_s,
        "runtime": runtime,
        "device_ops": top(op_s),
        "idle_gaps": top(idle),
    }


# ---- the run -----------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What an entry's run gives the harness.

    ``metrics``: the end-to-end values the entry measured; ``units``: what
    the traced window holds (``epochs``, ``graphs``, ``jobs``); ``info``:
    the counts per-layer readers use (``flops_per_epoch``, ...);
    ``values``: the numbers compared, by name."""

    setup_s: float
    metrics: Dict[str, float]
    units: Dict[str, float]
    info: Dict[str, Any]
    values: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Dict[str, Any] | None = None


def per_layer_values(cell: Cell, out: Outcome) -> Dict[str, float]:
    """Each per-layer metric of the cell its reader finds something for."""
    found = {}
    for m in cell.per_layer:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(out, cell)
        if value is not None:
            found[m["name"]] = value
    return found


def device_info(cell: Cell, out: Outcome) -> Dict[str, Any]:
    import torch

    on_card = cell.device.startswith("cuda")
    info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    if out.trace is not None:
        info.update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
    return info


def result(cell: Cell, out: Outcome) -> Dict[str, Any]:
    """The result line's object, the checks' key last."""
    found = checks(cell.limits, out.values)
    correct = bool(found) and all(c.ok for c in found) and out.failed == 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if cell.trace:
        values = per_layer_values(cell, out)
    else:
        values = {"setup_s": out.setup_s, **out.metrics}
        values = {k: v for k, v in values.items() if k in units}
    line: Dict[str, Any] = {
        "correct": correct,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in values.items()},
        "device": device_info(cell, out),
    }
    if out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
    return line


def run_cell(cell: Cell, t0: float) -> Dict[str, Any]:
    """Run ``cell`` through its entry module; returns the result object.  ``t0``:
    the process's start on ``time.perf_counter``."""
    out = cell.entry().run(cell, cell.reference(), t0)
    if out.trace is not None:
        print("trace runtime calls " + json.dumps(out.trace["runtime"], sort_keys=True),
              file=sys.stderr)
    return result(cell, out)


def now() -> float:
    return time.perf_counter()


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile with linear interpolation (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def print_checks(line: Dict[str, Any], stream=sys.stderr) -> None:
    """Each compared number beside its limit, one a line."""
    for name, c in line.get("checks", {}).items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=stream)
