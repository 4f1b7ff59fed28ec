"""Run one cell of the benchmark of gcn_maxcut_tpu_torch.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, ``breakdown`` (traced runs) and
``checks``, each compared number beside its limit, which also end standard
error.  Exit codes: 0 a result, 2 a cell or file not found, 3 no CUDA
device or too few, 4 JAX or the JAX package loaded; anything else, the
run failed.  ``benchmark/tests/readings.py`` runs the same cells for the
limits' readings (many seeds, the control, planted faults).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout; keep libraries
# that could load JAX away from it.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except (FileNotFoundError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    line = harness.run_cell(cell, T0)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: loaded {', '.join(bad)} (JAX or the JAX package)", file=sys.stderr)
        return 4
    harness.print_checks(line)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
