"""Heuristic baselines: greedy flips, simulated annealing, BLS, and the
recursive 2-way-split k-way heuristic.

Port of ``gcn_maxcut_tpu/baselines/local_search.py``.  All share one
primitive: the class-weight matrix ``W[i, c] = Σ_{j∈N(i), a_j = c} w_ij``,
one SpMM over the one-hot assignment (``ops/segment.spmm``, COO path).
Moving node i from class a to class c changes the cut by
``W[i, a] − W[i, c]``.

``greedy_flip_local_search`` takes one assignment ``[n_pad]`` or a batch
``[S, n_pad]``; a batch climbs in lockstep, one SpMM on ``[n_pad, S·k]`` a
step (the JAX package ``vmap``s its ``while_loop``).  A climb with no
improving move maps to itself, so a finished climb stays where it is while
the others go on, as in the JAX loop.

Random draws come from an explicit ``torch.Generator``.  Each randomized
search also has a ``*_from_draws`` form that takes its draws as tensors,
so that a test can feed it the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.ops.segment import spmm

# The climb reads "did any start improve?" on the host once every this many
# steps (a read per step would be one host round trip per move).
_SYNC_EVERY = 16


def _class_weights(g: Graph, assignment: torch.Tensor, k: int) -> torch.Tensor:
    """W[..., i, c] = total edge weight from node i into class c, for
    ``assignment`` [n_pad] or [S, n_pad]."""
    onehot = torch.nn.functional.one_hot(assignment.long(), k).float()
    if onehot.dim() == 2:
        return spmm(g, onehot, edge_weights=g.weights * g.edge_mask)
    s = onehot.shape[0]
    x = onehot.permute(1, 0, 2).reshape(g.n_pad, s * k)
    w = spmm(g, x, edge_weights=g.weights * g.edge_mask)
    return w.reshape(g.n_pad, s, k).permute(1, 0, 2)


def _move_gains(
    g: Graph, assignment: torch.Tensor, k: int, num_fixed: int
) -> torch.Tensor:
    """gains[..., i, c]: cut delta of moving node i to class c (−inf if
    illegal or staying put)."""
    asn = assignment.long()
    w = _class_weights(g, asn, k)
    gains = torch.gather(w, -1, asn[..., None]) - w
    ids = torch.arange(g.n_pad, device=asn.device)
    movable = (ids >= num_fixed) & (g.node_mask > 0)
    gains = torch.where(movable[:, None], gains, -torch.inf)
    stay = torch.nn.functional.one_hot(asn, k).bool()
    return torch.where(stay, -torch.inf, gains)


def greedy_flip_local_search(
    g: Graph,
    assignment: torch.Tensor,
    k: int = 3,
    num_fixed: int = 3,
    max_steps: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement single-node moves until a local optimum or
    ``max_steps`` steps.  Returns ``(assignment, cut_value)``, batched like
    the input.

    Each step applies, per start, the first best (row-major over
    ``[n_pad, k]``) strictly improving move, gain > 1e-6.
    """
    batched = assignment.dim() == 2
    asn = (assignment if batched else assignment[None]).long().clone()
    rows = torch.arange(asn.shape[0], device=asn.device)
    steps = 0
    while steps < max_steps:
        for _ in range(min(_SYNC_EVERY, max_steps - steps)):
            gains = _move_gains(g, asn, k, num_fixed).reshape(asn.shape[0], -1)
            flat = torch.argmax(gains, dim=1)
            take = gains[rows, flat] > 1e-6
            i, c = flat // k, flat % k
            asn[rows, i] = torch.where(take, c, asn[rows, i])
            steps += 1
        if not bool(take.any()):
            break
    out = asn if batched else asn[0]
    return out, hard_cut_value(g, out)


def simulated_annealing_from_draws(
    g: Graph,
    assignment: torch.Tensor,
    nodes: torch.Tensor,
    classes: torch.Tensor,
    uniforms: torch.Tensor,
    k: int = 3,
    t_start: float = 2.0,
    t_end: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metropolis moves with linear cooling over the given draws: step t
    proposes moving ``nodes[t]`` to ``classes[t]`` and accepts a worsening
    move when ``uniforms[t] < exp(delta / T_t)``.  W is kept up to date
    incrementally; returns the best ``(assignment, cut)`` seen."""
    steps = int(nodes.shape[0])
    asn = assignment.long().clone()
    w = _class_weights(g, asn, k)
    cut = hard_cut_value(g, asn)
    best_asn, best_cut = asn.clone(), cut.clone()
    ts = torch.linspace(t_start, t_end, steps, device=asn.device)
    senders, receivers = g.senders.long(), g.receivers.long()
    real = g.edge_mask > 0
    zeros = torch.zeros(g.n_pad, device=asn.device)
    for t in range(steps):
        i, c = nodes[t].long(), classes[t].long()
        a = asn[i]
        delta = w[i, a] - w[i, c]                 # the cut grows by delta
        legal = (c != a) & (g.node_mask[i] > 0)
        accept = legal & (
            (delta > 0)
            | (uniforms[t] < torch.exp(torch.clamp(delta / ts[t], max=0.0)))
        )
        # every neighbour j of i moves w_ij from column a to column c
        wts = torch.where((receivers == i) & real, g.weights, 0.0)
        upd = zeros.index_add(0, senders, wts)
        move = torch.nn.functional.one_hot(c, k) - torch.nn.functional.one_hot(a, k)
        w = torch.where(accept, w + upd[:, None] * move, w)
        asn[i] = torch.where(accept, c, a)
        cut = torch.where(accept, cut + delta, cut)
        better = cut > best_cut
        best_asn = torch.where(better, asn, best_asn)
        best_cut = torch.where(better, cut, best_cut)
    return best_asn, best_cut


def simulated_annealing(
    g: Graph,
    assignment: torch.Tensor,
    generator: torch.Generator,
    k: int = 3,
    num_fixed: int = 3,
    steps: int = 5000,
    t_start: float = 2.0,
    t_end: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated annealing (reference heuristics notebook cell 10): node
    proposals uniform over the movable ids, classes uniform."""
    dev = assignment.device
    nodes = torch.randint(num_fixed, g.n_pad, (steps,), generator=generator, device=dev)
    classes = torch.randint(0, k, (steps,), generator=generator, device=dev)
    uniforms = torch.rand((steps,), generator=generator, device=dev)
    return simulated_annealing_from_draws(
        g, assignment, nodes, classes, uniforms, k, t_start, t_end
    )


def _set_last_wins(
    asn: torch.Tensor, nodes: torch.Tensor, classes: torch.Tensor
) -> torch.Tensor:
    """``asn[nodes] = classes`` where, for a node listed more than once, the
    last listed class wins.  Every duplicate writes that same class, so the
    scatter's order on the device cannot change the result."""
    nodes, classes = nodes.long(), classes.long()
    same = nodes[:, None] == nodes[None, :]
    pos = torch.arange(nodes.shape[0], device=nodes.device)
    last = torch.where(same, pos[None, :], -1).amax(dim=1)
    out = asn.clone()
    out[nodes] = classes[last]
    return out


def breakout_local_search_from_draws(
    g: Graph,
    initial: torch.Tensor,
    nodes: torch.Tensor,
    classes: torch.Tensor,
    k: int = 3,
    num_fixed: int = 3,
    max_steps_per_round: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BLS over the given draws: ``initial`` [n_pad] is the first start
    (ids below ``num_fixed`` are pinned to themselves), and round r + 1
    perturbs ``nodes[r]`` to ``classes[r]`` ([rounds − 1, P]; a node drawn
    twice takes its last class) before climbing again.  Keeps the best
    local optimum (strictly better cuts replace it)."""
    ids = torch.arange(g.n_pad, device=initial.device)
    asn = torch.where(ids < num_fixed, ids, initial.long())
    best_asn, best_cut = greedy_flip_local_search(g, asn, k, num_fixed, max_steps_per_round)
    asn = best_asn
    for r in range(nodes.shape[0]):
        asn = _set_last_wins(asn, nodes[r], classes[r])
        asn, cut = greedy_flip_local_search(g, asn, k, num_fixed, max_steps_per_round)
        take = cut > best_cut
        best_asn = torch.where(take, asn, best_asn)
        best_cut = torch.where(take, cut, best_cut)
    return best_asn, best_cut


def breakout_local_search(
    g: Graph,
    generator: torch.Generator,
    k: int = 3,
    num_fixed: int = 3,
    rounds: int = 10,
    perturbation_size: int = 8,
    max_steps_per_round: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BLS (reference heuristics notebook cell 8): descend to a local
    optimum, perturb ``perturbation_size`` random non-terminal nodes,
    repeat; keep the best local optimum seen."""
    dev = g.device
    initial = torch.randint(0, k, (g.n_pad,), generator=generator, device=dev)
    shape = (max(0, rounds - 1), perturbation_size)
    nodes = torch.randint(num_fixed, g.n_pad, shape, generator=generator, device=dev)
    classes = torch.randint(0, k, shape, generator=generator, device=dev)
    return breakout_local_search_from_draws(
        g, initial, nodes, classes, k, num_fixed, max_steps_per_round
    )


def _two_way_split(
    g: Graph, active: torch.Tensor, t0: int, t1: int, sides: torch.Tensor
) -> torch.Tensor:
    """The best of the random 2-way splits ``sides`` [restarts, n_pad] of
    the ``active`` node subset (first best on ties), cut counted over the
    induced subgraph's edges, terminals ``t0``/``t1`` pinned to sides 0/1.
    Returns the 0/1 side array [n_pad]."""
    ids = torch.arange(g.n_pad, device=sides.device)
    a = torch.where(ids == t0, 0, torch.where(ids == t1, 1, sides.long()))
    s, r = g.senders.long(), g.receivers.long()
    intra = active[s] * active[r] * g.edge_mask * g.weights
    cuts = 0.5 * torch.sum(intra * (a[:, s] != a[:, r]), dim=-1)
    return a[torch.argmax(cuts)]


def multi_max_cut_recursive_from_draws(
    g: Graph,
    terminals: Sequence[int],
    sides_at: Callable[[Tuple[int, ...]], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive 2-way splits over the given draws: the split of the subset
    reached by ``path`` (a tuple of 0/1 sides from the root) picks from
    ``sides_at(path)``, [restarts, n_pad] random 0/1 sides."""
    class_of = {int(t): c for c, t in enumerate(terminals)}
    asn = np.zeros((g.n_pad,), np.int64)

    def rec(active: np.ndarray, terms: List[int], path: Tuple[int, ...]) -> None:
        if len(terms) == 1:
            asn[active] = class_of[int(terms[0])]
            return
        side = _two_way_split(
            g, torch.as_tensor(active, dtype=torch.float32, device=g.device),
            int(terms[0]), int(terms[1]), sides_at(path),
        ).cpu().numpy()
        side0 = active & (side == 0)
        side1 = active & (side == 1)
        rec(side0, [terms[0]] + [t for t in terms[2:] if side0[int(t)]], path + (0,))
        rec(side1, [terms[1]] + [t for t in terms[2:] if side1[int(t)]], path + (1,))

    rec(g.node_mask.cpu().numpy() > 0, list(terminals), ())
    out = torch.as_tensor(asn, device=g.device)
    return out, hard_cut_value(g, out)


def multi_max_cut_recursive(
    g: Graph,
    terminals: Sequence[int],
    generator: torch.Generator,
    restarts: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-way max cut by recursive 2-way splits (reference
    ``huerestics_multi-max.ipynb`` cell 6).

    Each split is the best of ``restarts`` random bisections of the current
    subset with two terminals pinned apart; both sides recurse on the
    terminals they hold (the JAX package's deviation from the reference,
    which can leave terminals co-partitioned), so all k terminals end in k
    distinct classes.  Returns ``(assignment [n_pad], cut_value)`` with
    ``terminals[c]`` in class c.
    """
    def sides_at(path: Tuple[int, ...]) -> torch.Tensor:
        return torch.randint(0, 2, (restarts, g.n_pad), generator=generator, device=g.device)

    return multi_max_cut_recursive_from_draws(g, terminals, sides_at)
