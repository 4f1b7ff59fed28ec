"""Decoders: argmax assignment, best-of-N sampled rounding, the greedy-flip
refine and the class-relabeling search.

Port of ``gcn_maxcut_tpu/eval/decode.py``.  All rollouts are sampled and
scored in one batched pass; the multi-start refine climbs its starts in
lockstep in one batched greedy flip.  Uniforms come from an explicit
``torch.Generator``; the ``*_from_uniforms`` forms take them as given so
that a test can feed both frameworks the same draws.
"""

from __future__ import annotations

from itertools import permutations
from typing import Tuple

import torch

from gcn_maxcut_tpu_torch.baselines.local_search import greedy_flip_local_search
from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value


def simple_assignment(probs: torch.Tensor, num_terminals: int = 3) -> torch.Tensor:
    """Row argmax, then terminals ``0..t-1`` forced to their own classes."""
    assignment = torch.argmax(probs, dim=-1)
    ids = torch.arange(assignment.shape[0], device=probs.device)
    return torch.where(ids < num_terminals, ids, assignment)


def sample_partitions_from_uniforms(
    probs: torch.Tensor, u: torch.Tensor, num_terminals: int = 3
) -> torch.Tensor:
    """``[S, n]`` inverse-CDF samples from uniforms ``u`` [S, n, 1]: the
    first class whose cumulative probability exceeds u, falling back to the
    last class when a row sums below u (the reference's semantics)."""
    n, k = probs.shape
    cdf = torch.cumsum(probs, dim=-1)
    sampled = torch.sum(u >= cdf[None, :, :], dim=-1)
    sampled = torch.clamp(sampled, 0, k - 1)
    ids = torch.arange(n, device=probs.device)[None, :]
    return torch.where(ids < num_terminals, ids, sampled)


def rollout_uniforms(
    probs: torch.Tensor, generator: torch.Generator, num_samples: int
) -> torch.Tensor:
    """The uniforms of ``num_samples`` rollouts, [num_samples, n, 1]."""
    return torch.rand(
        (num_samples, probs.shape[0], 1), generator=generator,
        dtype=probs.dtype, device=probs.device,
    )


def sample_partitions(
    probs: torch.Tensor,
    generator: torch.Generator,
    num_samples: int,
    num_terminals: int = 3,
) -> torch.Tensor:
    """``[num_samples, n]`` categorical samples; terminals pinned."""
    u = rollout_uniforms(probs, generator, num_samples)
    return sample_partitions_from_uniforms(probs, u, num_terminals)


def best_of_samples(g: Graph, samples: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best assignment, its cut) among ``samples`` [S, n_pad]; the first
    best on ties."""
    cuts = hard_cut_value(g, samples)
    best = torch.argmax(cuts)
    return samples[best], cuts[best]


def post_process(
    g: Graph,
    probs: torch.Tensor,
    generator: torch.Generator,
    iterations: int = 200,
    num_terminals: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-of-N sampled rounding: ``(best_assignment, best_cut)``."""
    samples = sample_partitions(probs, generator, iterations, num_terminals)
    return best_of_samples(g, samples)


def refine_with_local_search(
    g: Graph,
    assignment: torch.Tensor,
    k: int = 3,
    num_terminals: int = 3,
    max_steps: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy single-node flips from a decoded assignment to a local
    optimum: ``(assignment, cut)``."""
    return greedy_flip_local_search(g, assignment, k, num_terminals, max_steps)


def refine_multi_start_from_uniforms(
    g: Graph,
    probs: torch.Tensor,
    u: torch.Tensor,
    starts: int = 4,
    k: int = 3,
    num_terminals: int = 3,
    max_steps: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy flips from the top ``starts − 1`` samples of uniforms ``u``
    [S, n_pad, 1] plus the argmax decode, climbed in one batched pass; the
    first best result.

    Cuts are whole numbers, so samples tie often: the top samples are the
    last ``starts − 1`` of a stable ascending sort of the cuts, in that
    order, then the argmax start (the JAX package's order), so that ties
    resolve to the same assignment.
    """
    samples = sample_partitions_from_uniforms(probs, u, num_terminals)
    cuts = hard_cut_value(g, samples)
    top = torch.argsort(cuts, stable=True)[-max(1, starts - 1):]
    start_asn = torch.cat([samples[top], simple_assignment(probs, num_terminals)[None]])
    asns, rcuts = greedy_flip_local_search(g, start_asn, k, num_terminals, max_steps)
    best = torch.argmax(rcuts)
    return asns[best], rcuts[best]


def refine_multi_start(
    g: Graph,
    probs: torch.Tensor,
    generator: torch.Generator,
    iterations: int = 200,
    starts: int = 4,
    k: int = 3,
    num_terminals: int = 3,
    max_steps: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The default decode: greedy-flip refinement from the best ``starts −
    1`` of ``iterations`` sampled assignments plus the argmax decode."""
    u = rollout_uniforms(probs, generator, iterations)
    return refine_multi_start_from_uniforms(
        g, probs, u, starts, k, num_terminals, max_steps
    )


def terminal_permutation_search(
    g: Graph, probs: torch.Tensor, num_terminals: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best argmax decode over all k! relabelings of the classes
    (terminals stay pinned): ``(best_assignment, best_cut)``, the first
    best in ``itertools.permutations`` order."""
    k = probs.shape[-1]
    asns = torch.stack([
        simple_assignment(probs[:, list(perm)], num_terminals)
        for perm in permutations(range(k))
    ])
    cuts = hard_cut_value(g, asns)
    best = torch.argmax(cuts)
    return asns[best], cuts[best]
