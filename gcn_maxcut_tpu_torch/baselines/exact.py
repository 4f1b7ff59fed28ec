"""Exact and anytime solvers: the CPLEX CP Optimizer stand-in.

Port of ``gcn_maxcut_tpu/baselines/exact.py``, with the same names,
arguments and result keys:

  * ``brute_force_maxcut``: the exhaustive optimum for small n, every
    k^(n−t) assignment scored in device batches;
  * ``recursive_flow_min_cut``: recursive 2-way s–t min-cuts over every
    terminal ordering (host SciPy max-flow), the reference's flow baseline;
  * ``anytime_solver``: exact for small n, else batches of simulated
    annealing + greedy descent chains until the time limit;
  * ``solver_balanced``: the anytime solution repaired to ⌊n/k⌋-balanced
    classes.

Deliberate differences from JAX:

  * random draws come from a ``torch.Generator`` seeded with ``seed`` on
    the graph's device, not from ``jax.random`` keys;
    ``_sa_restart_batch_from_draws`` takes the draws as tensors, so a test
    can hand it the JAX package's;
  * ``brute_force_maxcut`` keeps the running best on the device and reads
    it once at the end (JAX reads every batch back); the tie rule is the
    JAX one (the first maximum within a batch, strictly greater across
    batches: the first optimal code overall), so the optimum and its
    assignment are JAX's;
  * in ``recursive_flow_min_cut`` the nodes left after an ordering's splits
    go to the ordering's last terminal, ``order[-1]``.  JAX gives them to
    ``terminals[-1]`` (``exact.py:150``), which for an ordering that does
    not end in the last terminal merges that class into another one and
    can return a worse assignment (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.baselines.local_search import (
    _class_weights,
    greedy_flip_local_search,
    simulated_annealing_from_draws,
)
from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value

BRUTE_FORCE_LIMIT = 50_000_000


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def brute_force_maxcut(
    g: Graph,
    k: int = 3,
    num_fixed: int = 3,
    batch: int = 4096,
) -> Tuple[np.ndarray, float]:
    """Exhaustive k-way max-cut with terminals pinned; n−t ≤ ~16 for k=3.

    Enumerates the k^(n−t) free-node assignments (mixed-radix codes, the
    first free node the least significant digit) in batches of ``batch``
    on ``g``'s device, each scored by ``hard_cut_value`` on [b, n_pad].
    Returns ``(assignment[:n], optimal_cut)``.
    """
    n = int(g.n_nodes)
    free = n - num_fixed
    total = k**free
    if total > BRUTE_FORCE_LIMIT:
        raise ValueError(f"k^(n-t) = {total} too large for brute force")
    dev = g.device
    pows = torch.as_tensor(k ** np.arange(free, dtype=np.int64), device=dev)
    ids = torch.arange(g.n_pad, device=dev)
    best_cut = torch.tensor(-np.inf, device=dev)
    best_code = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, total, batch):
        codes = torch.arange(start, min(start + batch, total), device=dev)
        digits = (codes[:, None] // pows[None, :]) % k
        asn = torch.nn.functional.pad(digits, (num_fixed, g.n_pad - n))
        asn = torch.where(ids < num_fixed, ids, asn)
        cuts = hard_cut_value(g, asn)
        i = torch.argmax(cuts)
        take = cuts[i] > best_cut
        best_cut = torch.where(take, cuts[i], best_cut)
        best_code = torch.where(take, codes[i], best_code)
    code = int(best_code)
    digits = (code // k ** np.arange(free, dtype=np.int64)) % k
    assignment = np.concatenate([np.arange(num_fixed), digits]).astype(np.int64)
    return assignment[:n], float(best_cut)


def _st_min_cut(adj: np.ndarray, source: int, sink: int) -> Tuple[float, np.ndarray]:
    """s–t min cut via SciPy's max-flow; returns ``(cut_weight,
    side_mask)``, ``side_mask[i]`` True if i is on the source side."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    n = adj.shape[0]
    scale = 1000                        # maximum_flow needs integer capacities
    cap = csr_matrix((adj * scale).astype(np.int64))
    res = maximum_flow(cap, source, sink)
    # the source side: what the source reaches in the residual graph
    residual = cap - res.flow
    residual.data = np.maximum(residual.data, 0)
    reach = breadth_first_order(residual, source, directed=True, return_predecessors=False)
    side = np.zeros(n, dtype=bool)
    side[reach] = True
    return res.flow_value / scale, side


def _ordering_assignment(adj: np.ndarray, order, residual_class: int) -> np.ndarray:
    """One ordering's k-way split: each terminal but the last in turn is
    cut off from the others (an s–t min cut against a super-sink of the
    remaining terminals) and takes its source side; the nodes left take
    ``residual_class``."""
    n = adj.shape[0]
    remaining = np.ones(n, dtype=bool)
    asn = np.full(n, residual_class, dtype=np.int64)
    for t in order[:-1]:
        others = [u for u in order if u != t and remaining[u]]
        sub_idx = np.nonzero(remaining)[0]
        pos = {v: i for i, v in enumerate(sub_idx)}
        sub = adj[np.ix_(sub_idx, sub_idx)].copy()
        # the super-sink: the first remaining other terminal, joined to the
        # rest by edges of more than the whole subgraph's weight
        sink = pos[others[0]]
        big = sub.sum() + 1
        for u in others[1:]:
            sub[pos[u], sink] = big
            sub[sink, pos[u]] = big
        _, side = _st_min_cut(sub, pos[t], sink)
        members = sub_idx[side]
        asn[members] = t
        remaining[members] = False
    return asn


def recursive_flow_min_cut(g: Graph, num_terminals: int = 3) -> Tuple[np.ndarray, float]:
    """k-way cut by recursive 2-way s–t min-cuts over terminal orderings.

    The reference's flow-based ``recursive_min_cut`` /
    ``find_optimal_k_way_cut`` (``prepareData.ipynb`` cell 6): for each
    permutation of the terminals, split off one terminal at a time; keep
    the ordering whose assignment cuts most (the first on ties).  A
    multiway min-cut heuristic, not a max-cut solver.  Returns
    ``(assignment[:n], cut_value_of_assignment)``.
    """
    n = int(g.n_nodes)
    adj = np.zeros((n, n), dtype=np.float64)
    s_np, r_np = g.senders.cpu().numpy(), g.receivers.cpu().numpy()
    w_np = g.weights.cpu().numpy()
    m = g.edge_mask.cpu().numpy() > 0
    adj[r_np[m], s_np[m]] = w_np[m]

    best_asn, best_val = None, -np.inf
    for order in itertools.permutations(range(num_terminals)):
        asn = _ordering_assignment(adj, order, order[-1])
        full = np.zeros(g.n_pad, dtype=np.int64)
        full[:n] = asn
        val = float(hard_cut_value(g, torch.as_tensor(full, device=g.device)))
        if val > best_val:
            best_val, best_asn = val, asn.copy()
    return best_asn, best_val


def _sa_restart_batch_from_draws(
    g: Graph,
    init: torch.Tensor,
    nodes: torch.Tensor,
    classes: torch.Tensor,
    uniforms: torch.Tensor,
    k: int,
    num_fixed: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R chains over the given draws: starts ``init`` [R, n_pad] (ids below
    ``num_fixed`` pinned to themselves), SA proposals [R, steps], then the
    greedy climb, all R in lockstep.  Returns the best chain's
    ``(assignment [n_pad], cut)``, the first on ties."""
    ids = torch.arange(g.n_pad, device=init.device)
    init = torch.where(ids < num_fixed, ids, init.long())
    asn, _ = simulated_annealing_from_draws(g, init, nodes, classes, uniforms, k)
    asns, cuts = greedy_flip_local_search(g, asn, k, num_fixed)
    best = torch.argmax(cuts)
    return asns[best], cuts[best]


def _sa_restart_batch(
    g: Graph,
    generator: torch.Generator,
    k: int,
    num_fixed: int,
    sa_steps: int,
    restarts: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``restarts`` independent SA + greedy-descent chains in one batched
    pass on ``g``'s device, drawn from ``generator`` (on that device);
    returns the best chain's ``(assignment, cut)``."""
    dev = g.device
    shape = (restarts, sa_steps)
    init = torch.randint(0, k, (restarts, g.n_pad), generator=generator, device=dev)
    nodes = torch.randint(num_fixed, g.n_pad, shape, generator=generator, device=dev)
    classes = torch.randint(0, k, shape, generator=generator, device=dev)
    uniforms = torch.rand(shape, generator=generator, device=dev)
    return _sa_restart_batch_from_draws(g, init, nodes, classes, uniforms, k, num_fixed)


def anytime_solver(
    g: Graph,
    k: int = 3,
    time_limit: float = 300.0,
    num_fixed: int = 3,
    seed: int = 0,
    exact_threshold: int = 18,
    sa_steps: int = 20_000,
    batch_restarts: int | None = None,
    solution_limit: int | None = None,
) -> Dict[str, object]:
    """CPLEX ``cplex_solver`` replacement (the reference's ``:93-188``).

    Exact (brute force) when n − t ≤ ``exact_threshold`` and k^(n−t) ≤
    50M; otherwise batches of ``batch_restarts`` SA + greedy chains (default
    max(8, min(64, 2^22 // n_pad))) until ``time_limit`` seconds have
    passed, stopping after a batch past 0.9 of it.  ``solution_limit``
    stops after that many chains, the last batch clamped to it (CPLEX's
    ``SolutionLimit``).  Returns ``assignment``, ``cut_value``,
    ``solve_time`` (after a device synchronize), ``method`` and
    ``restarts``.
    """
    n = int(g.n_nodes)
    dev = g.device
    t0 = time.perf_counter()
    if n - num_fixed <= exact_threshold and k ** (n - num_fixed) <= BRUTE_FORCE_LIMIT:
        asn, cut = brute_force_maxcut(g, k, num_fixed)
        _sync(dev)
        return {
            "assignment": asn,
            "cut_value": cut,
            "solve_time": time.perf_counter() - t0,
            "method": "exact_brute_force",
            "restarts": 0,
        }

    if batch_restarts is None:
        batch_restarts = int(max(8, min(64, (1 << 22) // max(g.n_pad, 1))))
    generator = torch.Generator(device=dev).manual_seed(seed)
    best_cut, best_asn = -np.inf, None
    restarts = 0
    while time.perf_counter() - t0 < time_limit:
        if solution_limit is not None and restarts >= solution_limit:
            break
        batch = (batch_restarts if solution_limit is None
                 else min(batch_restarts, solution_limit - restarts))
        asn, cut = _sa_restart_batch(g, generator, k, num_fixed, sa_steps, batch)
        cut = float(cut)
        if cut > best_cut:
            best_cut = cut
            best_asn = asn[:n].cpu().numpy()
        restarts += batch
        if restarts >= batch_restarts and time.perf_counter() - t0 > time_limit * 0.9:
            break
    _sync(dev)
    return {
        "assignment": best_asn,
        "cut_value": best_cut,
        "solve_time": time.perf_counter() - t0,
        "method": "sa_anytime",
        "restarts": restarts,
    }


def solver_balanced(
    g: Graph,
    k: int = 3,
    time_limit: float = 300.0,
    num_fixed: int = 3,
    seed: int = 0,
) -> Dict[str, object]:
    """Balanced variant (the reference's ``cplex_solver_balanced``
    ``:190-304``): the anytime solution (half the time limit, at least 1 s)
    repaired towards ⌊n/k⌋ nodes a class.  While a class is over and
    another under the target, the first overfull class gives up the
    non-terminal node whose move into an underfull class loses least."""
    n = int(g.n_nodes)
    result = anytime_solver(g, k, time_limit=max(1.0, time_limit / 2),
                            num_fixed=num_fixed, seed=seed)
    asn = np.array(result["assignment"], dtype=np.int64)
    target = n // k

    def padded(a: np.ndarray) -> torch.Tensor:
        full = np.zeros(g.n_pad, dtype=np.int64)
        full[:n] = a
        return torch.as_tensor(full, device=g.device)

    for _ in range(2 * n):
        sizes = np.bincount(asn, minlength=k)
        over = [c for c in range(k) if sizes[c] > target]
        under = [c for c in range(k) if sizes[c] < target]
        if not over or not under:
            break
        w = _class_weights(g, padded(asn), k).cpu().numpy()[:n]
        c_from = over[0]
        cand = np.nonzero(asn[num_fixed:] == c_from)[0] + num_fixed
        if cand.size == 0:
            break
        under_arr = np.asarray(under)
        # delta[i, c_to]: the cut's change when node cand[i] moves to c_to
        delta = w[cand, c_from][:, None] - w[np.ix_(cand, under_arr)]
        flat = int(np.argmax(delta))
        asn[cand[flat // under_arr.size]] = under_arr[flat % under_arr.size]

    cut = float(hard_cut_value(g, padded(asn)))
    sizes = np.bincount(asn, minlength=k).tolist()
    result.update({"assignment": asn, "cut_value": cut,
                   "method": "balanced_" + str(result["method"]), "partition_sizes": sizes})
    return result
