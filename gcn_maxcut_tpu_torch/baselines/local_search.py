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
the others go on, as in the JAX loop.  ``simulated_annealing_from_draws``
likewise takes R chains ``[R, n_pad]`` that step in lockstep (the batched
restarts of ``exact.anytime_solver``).

Both loops run as the JAX package runs them, in one device call, as far as
a card allows: a lockstep step is the step of a ``train.chunks.
ChunkRunner``, on the card captured once into a CUDA graph and replayed a
step at a time, the host reading once a block of steps (the climb's stop
flag every ``_SYNC_EVERY`` steps, the chains every ``_SA_BLOCK``).
The climb's step works on buffers of one padded shape (n_pad, e_pad,
starts, k, fixed ids) into which each graph and its starts are copied, so
one capture serves every graph of that shape: the card keeps the last
``_CLIMBS_KEPT`` such climbs.  The chains read step t's draws and
temperature through a step index held on the device.  On the CPU the same
steps run eagerly, on the caller's tensors.  ``clear_climbs()`` drops the
kept climbs and their graphs' memory.

Random draws come from an explicit ``torch.Generator``.  Each randomized
search also has a ``*_from_draws`` form that takes its draws as tensors,
so that a test can feed it the JAX package's draws.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.ops.segment import spmm
from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

# The climb reads "did any start improve?" on the host once every this many
# steps (a read per step would be one host round trip per move).
_SYNC_EVERY = 16
# The SA chains run in chunks of at most this many steps, one host read each.
_SA_BLOCK = 1024
# Captured climbs the card keeps, the most recently used (see _Climb).
_CLIMBS_KEPT = 4
_CLIMBS: "OrderedDict[tuple, _Climb]" = OrderedDict()
# The graph fields a climb copies in: those its step reads, and the rest a
# Graph must hold.
_CLIMB_FIELDS = ("senders", "receivers", "weights", "edge_mask", "row_ptr", "degrees",
                 "node_mask", "n_nodes", "n_edges")


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


class _Climb:
    """The lockstep climb of ``starts`` assignments on graphs of one padded
    shape, on one device: a ``ChunkRunner`` over one step on the starts'
    buffer and a graph.  On the card the graph is a set of buffers (the
    step captured at the first block and replayed after), into which
    ``run`` copies each graph; elsewhere it is ``g`` itself."""

    def __init__(self, g: Graph, starts: int, k: int, num_fixed: int):
        self.g = (Graph(**{f: getattr(g, f).clone() for f in _CLIMB_FIELDS})
                  if g.device.type == "cuda" else g)
        self.asn = torch.zeros((starts, g.n_pad), dtype=torch.int64, device=g.device)
        self.rows = torch.arange(starts, device=g.device)
        self.k, self.num_fixed = k, num_fixed
        self.runner = ChunkRunner(self._step, [g.device], _SYNC_EVERY)

    def _step(self) -> Tuple[None, torch.Tensor]:
        """One move a start, the first best (row-major over ``[n_pad, k]``)
        strictly improving one, gain > 1e-6; returns (no loss, no start
        moved)."""
        asn, rows, k = self.asn, self.rows, self.k
        gains = _move_gains(self.g, asn, k, self.num_fixed).reshape(asn.shape[0], -1)
        flat = torch.argmax(gains, dim=1)
        take = gains[rows, flat] > 1e-6
        i, c = flat // k, flat % k
        asn[rows, i] = torch.where(take, c, asn[rows, i])
        return None, ~take.any()

    def run(self, g: Graph, asn: torch.Tensor, max_steps: int) -> torch.Tensor:
        if self.g is not g:
            for f in _CLIMB_FIELDS:
                getattr(self.g, f).copy_(getattr(g, f))
        self.asn.copy_(asn)
        self.runner.run_many(max_steps, until_stop=True)
        return self.asn.clone()


def _climb(g: Graph, starts: int, k: int, num_fixed: int) -> _Climb:
    """The climb for ``g``'s padded shape: on the card the one kept for it
    (built at first use; the least recently used of more than
    ``_CLIMBS_KEPT`` is dropped), elsewhere a new one."""
    if g.device.type != "cuda":
        return _Climb(g, starts, k, num_fixed)
    key = (g.device, g.n_pad, g.e_pad, starts, k, num_fixed)
    climb = _CLIMBS.pop(key, None) or _Climb(g, starts, k, num_fixed)
    _CLIMBS[key] = climb
    while len(_CLIMBS) > _CLIMBS_KEPT:
        _CLIMBS.popitem(last=False)
    return climb


def clear_climbs() -> None:
    """Drop the climbs the card keeps (their captured steps, memory pools
    and graph buffers); the next climb of each shape captures again."""
    _CLIMBS.clear()


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
    ``[n_pad, k]``) strictly improving move, gain > 1e-6.  The steps run in
    blocks of ``_SYNC_EVERY`` (the last block shorter), and the climb stops
    after a block whose last step moved no start.
    """
    batched = assignment.dim() == 2
    asn = (assignment if batched else assignment[None]).long()
    asn = _climb(g, asn.shape[0], k, num_fixed).run(g, asn, max_steps)
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
    incrementally; returns the best ``(assignment, cut)`` seen.

    A batch of R chains, ``assignment`` [R, n_pad] with draws [R, steps],
    steps in lockstep: one step's launches serve every chain (the JAX
    package ``vmap``s its ``lax.scan``).  Each chain's W update is one
    ``index_add_`` over the flattened [R·n_pad] rows, the edge test on
    [R, e_pad].  One chain, [n_pad] with draws [steps], is the batch of
    one.  The steps run in chunks of ``_SA_BLOCK`` (on the card one
    captured step replayed), reading step t's draws at a device index.
    """
    batched = assignment.dim() == 2
    if not batched:
        assignment, nodes, classes, uniforms = (
            assignment[None], nodes[None], classes[None], uniforms[None])
    asn = assignment.long().clone()
    nodes, classes = nodes.long(), classes.long()
    chains, steps = nodes.shape
    dev = asn.device
    w = _class_weights(g, asn, k)                 # [R, n_pad, k]
    cut = hard_cut_value(g, asn)
    best_asn, best_cut = asn.clone(), cut.clone()
    ts = torch.linspace(t_start, t_end, steps, device=dev)
    rows = torch.arange(chains, device=dev)
    senders, receivers = g.senders.long(), g.receivers.long()
    real = g.edge_mask > 0
    # every chain's senders as rows of the flattened [R·n_pad] update
    flat_senders = (rows[:, None] * g.n_pad + senders[None, :]).reshape(-1)
    eye = torch.eye(k, device=dev)
    t = torch.zeros(1, dtype=torch.int64, device=dev)     # the step, on the device

    def step() -> None:
        i, c = nodes.index_select(1, t)[:, 0], classes.index_select(1, t)[:, 0]
        a = asn[rows, i]
        delta = w[rows, i, a] - w[rows, i, c]     # the cut grows by delta
        legal = (c != a) & (g.node_mask[i] > 0)
        accept = legal & (
            (delta > 0)
            | (uniforms.index_select(1, t)[:, 0]
               < torch.exp(torch.clamp(delta / ts.index_select(0, t), max=0.0)))
        )
        # every neighbour j of i moves w_ij from column a to column c
        wts = torch.where((receivers[None, :] == i[:, None]) & real, g.weights, 0.0)
        upd = torch.zeros(chains * g.n_pad, device=dev).index_add_(
            0, flat_senders, wts.reshape(-1)).view(chains, g.n_pad)
        move = eye[c] - eye[a]                    # [R, k]
        torch.where(accept[:, None, None], w + upd[:, :, None] * move[:, None, :], w, out=w)
        asn[rows, i] = torch.where(accept, c, a)
        torch.where(accept, cut + delta, cut, out=cut)
        better = cut > best_cut
        torch.where(better[:, None], asn, best_asn, out=best_asn)
        torch.where(better, cut, best_cut, out=best_cut)
        t.add_(1)

    ChunkRunner(step, [dev], max(1, min(steps, _SA_BLOCK))).run_many(steps)
    if not batched:
        return best_asn[0], best_cut[0]
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
