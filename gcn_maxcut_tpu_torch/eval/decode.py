"""Decoders: argmax assignment and best-of-N sampled rounding.

Port of ``gcn_maxcut_tpu/eval/decode.py`` (``simple_assignment``,
``sample_partitions``, ``post_process``).  All rollouts are sampled and
scored in one batched pass.  Uniforms come from an explicit
``torch.Generator``; ``sample_partitions_from_uniforms`` takes them as given
so that a test can feed both frameworks the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def sample_partitions(
    probs: torch.Tensor,
    generator: torch.Generator,
    num_samples: int,
    num_terminals: int = 3,
) -> torch.Tensor:
    """``[num_samples, n]`` categorical samples; terminals pinned."""
    u = torch.rand(
        (num_samples, probs.shape[0], 1), generator=generator,
        dtype=probs.dtype, device=probs.device,
    )
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
