"""The general traffic generator: every input of a run, made from ``--seed``.

A traffic file (``traffic/<name>.json``) holds the parameters; the entries
call these functions with them.  Each stream of draws is a numpy generator
seeded with ``(seed, stream)``, so one seed gives the same inputs in every
run and the streams do not overlap.  Any whole number is a seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

# draw streams of one seed
GRAPHS, HELDOUT, WEIGHTS, JOBS, ORDER, DRAWS, SAMPLE = range(7)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *stream])


def torch_seed(gen: np.random.Generator) -> int:
    """A seed for a ``torch.Generator``, drawn from ``gen``."""
    return int(gen.integers(2**62))


@dataclasses.dataclass
class GraphData:
    """An undirected simple graph on nodes 0..n-1, edges [m, 2] with u < v.
    Its terminals are nodes 0, 1, 2 (labels of a random regular graph are
    exchangeable, so fixed ids are random terminals)."""

    n: int
    d: int
    edges: np.ndarray

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def regular_edges(n: int, d: int, gen: np.random.Generator, restarts: int = 100) -> np.ndarray:
    """A simple d-regular graph on n nodes by the pairing model: shuffle the
    n·d stubs, keep every pair that is neither a loop nor a repeat, shuffle
    the rest again; start over when the rest cannot be paired."""
    if n * d % 2 or not 0 < d < n:
        raise ValueError(f"no simple {d}-regular graph on {n} nodes")
    for _ in range(restarts):
        stubs = np.repeat(np.arange(n, dtype=np.int64), d)
        gen.shuffle(stubs)
        edges: set = set()
        while stubs.size:
            pairs = np.sort(stubs.reshape(-1, 2), axis=1)
            left: List[int] = []
            for u, v in pairs.tolist():
                if u != v and (u, v) not in edges:
                    edges.add((u, v))
                else:
                    left += [u, v]
            if len(left) == stubs.size:
                break
            stubs = np.array(left, dtype=np.int64)
            gen.shuffle(stubs)
        if not stubs.size or len(edges) == n * d // 2:
            return np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    raise RuntimeError(f"could not pair a {d}-regular graph on {n} nodes")


def regular_graphs(seed: int, stream: int, sizes: Sequence[int],
                   degrees: Sequence[int]) -> List[GraphData]:
    """One d-regular graph for each size in ``sizes``.  The degrees are
    ``degrees`` = [lo, hi] in turn, lo, lo + 1, ..., hi, lo, ..., in an
    order drawn from the seed: every seed gets the same mix of degrees
    (which sets the padded edges, and so the work), in another order, and
    graphs of its own."""
    gen = rng(seed, stream)
    span = degrees[1] - degrees[0] + 1
    mix = gen.permutation([degrees[0] + j % span for j in range(len(sizes))])
    return [GraphData(int(n), int(d), regular_edges(int(n), int(d), gen))
            for n, d in zip(sizes, mix)]


def job_seed(seed: int, i: int, pool: int) -> int:
    """The graph seed of job ``i``: the jobs cycle through ``pool`` graphs
    (graph seeds 0..pool-1) in an order drawn from the seed, so that every
    seed runs the same graphs."""
    return int(rng(seed, JOBS).permutation(pool)[i % pool])


def circulant_offsets(d: int, bandwidth: int, seed: int) -> tuple:
    """The d shifts (s1, -s1, s2, -s2, ...) of the circulant graph of a
    giant job's seed: d/2 distinct s from 1..bandwidth, drawn by
    ``np.random.default_rng(seed).choice`` (the published giant graph's
    rule, kept here so that the reference builds its graph itself)."""
    gen = np.random.default_rng(seed)
    half = gen.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    return tuple(int(o) for s in half for o in (s, -s))
