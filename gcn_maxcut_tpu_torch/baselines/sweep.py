"""Scalable classical max-cut baseline: the first-improvement sweep search.

Port of ``gcn_maxcut_tpu/baselines/sweep.py``.  One sweep moves every
node, in index order, to its best class (later nodes see earlier moves),
O(E) a sweep, until no node moves.  It is the classical column of the
at-scale quality tables (PARITY §4–5), where the O(E)-per-move searches of
``local_search.py`` cannot run.  Host code on the native toolkit's
``gt_greedy_sweep``; both packages call that one function, so their
results are identical.

Deliberate difference from JAX: the JAX module falls back to a numpy
stochastic parallel sweep when the native toolkit is missing.  The port's
toolkit either loads (or builds) or raises (``native/bindings.library``),
so that fallback is never reached and is not ported; ``seed`` is kept for
the signature and unused.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_maxcut_tpu_torch.native.bindings import greedy_sweep_native


def greedy_sweep_maxcut(
    edges: np.ndarray,
    n: int,
    init_assignment: np.ndarray,
    k: int = 3,
    num_fixed: int = 3,
    weights: np.ndarray | None = None,
    max_sweeps: int = 100,
    seed: int = 0,
) -> Tuple[np.ndarray, float, int]:
    """Sweep local search from ``init_assignment`` over the undirected
    ``edges`` [E, 2].  Returns ``(assignment, cut_value, sweeps_used)``;
    terminals ``0..num_fixed-1`` never move."""
    return greedy_sweep_native(edges, n, init_assignment, k=k, num_fixed=num_fixed,
                               weights=weights, max_sweeps=max_sweeps)


__all__ = ["greedy_sweep_maxcut"]
