"""Graph generation: seeded random regular / G(n,p) graphs with terminals.

Port of ``gcn_maxcut_tpu/data/generate.py`` (host side).  Below n = 20,000
the samplers are pure numpy with one ``numpy.random.Generator`` per call;
from n = 20,000 the regular sampler is the native C++ one
(``native/graphtools.cpp`` through ``native/bindings.py``), as in the JAX
package.  Either way the same seed gives the same edges as the JAX package.
An unseeded regular draw at that size takes a fresh 64-bit seed (the JAX
package passes seed 0 there, so its unseeded draws are all one graph).
``regular_graph_on_device`` builds the circulant benchmark graph with torch
on a given device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GraphSpec:
    """Host-side graph record: undirected edge list + metadata."""

    n_nodes: int
    edges: np.ndarray                 # int64 [m, 2], u < v
    terminals: List[int]
    degree: int | None = None         # for regular graphs
    weights: np.ndarray | None = None # optional [m] float32; default all-1

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def random_regular_edges(
    n: int, d: int, seed: int | None = None, max_restarts: int = 200
) -> np.ndarray:
    """Sample a simple d-regular graph on n nodes via the pairing model.

    Repeatedly draws a random perfect matching on the n·d stubs, keeping
    the suitable pairs and reshuffling the rest, restarting when only
    unsuitable pairs (self-loops / multi-edges) remain (Steger–Wormald).
    Returns the sorted [n·d/2, 2] edge array with u < v.

    For n ≥ 20,000 the native sampler draws the graph (same scheme, another
    RNG stream); it raises when the native library neither loads nor
    builds.  Only when that sampler gives up (its restart budget) does the
    pairing model below take over, as in the JAX package.
    """
    if n * d % 2 != 0:
        raise ValueError(f"n*d must be even (n={n}, d={d})")
    if not 0 <= d < n:
        raise ValueError(f"need 0 <= d < n (n={n}, d={d})")
    if d == 0:
        return np.empty((0, 2), dtype=np.int64)

    if n >= 20_000:
        from gcn_maxcut_tpu_torch.native.bindings import library, random_regular_edges_native

        library()
        if seed is None:
            seed = int(np.random.default_rng().integers(2**64, dtype=np.uint64))
        try:
            return random_regular_edges_native(n, d, seed=int(seed))
        except RuntimeError:
            pass

    rng = np.random.default_rng(seed)
    for _ in range(max_restarts):
        stubs = np.repeat(np.arange(n, dtype=np.int64), d)
        rng.shuffle(stubs)
        edges: set[tuple[int, int]] = set()
        stalled = False
        while stubs.size:
            pairs = stubs.reshape(-1, 2)
            lo = np.minimum(pairs[:, 0], pairs[:, 1])
            hi = np.maximum(pairs[:, 0], pairs[:, 1])
            good = lo != hi
            fresh: set[tuple[int, int]] = set()
            retry: list[np.ndarray] = []
            for u, v, ok in zip(lo, hi, good):
                key = (int(u), int(v))
                if ok and key not in edges and key not in fresh:
                    fresh.add(key)
                else:
                    retry.append(np.array([u, v]))
            edges |= fresh
            if not retry:
                break
            leftover = np.concatenate(retry)
            if not fresh and leftover.size == stubs.size:
                stalled = True
                break
            stubs = leftover
            rng.shuffle(stubs)
        if not stalled and len(edges) == n * d // 2:
            return np.array(sorted(edges), dtype=np.int64)
    raise RuntimeError(f"failed to sample {d}-regular graph on {n} nodes")


def gnp_edges(n: int, p: float, seed: int | None = None) -> np.ndarray:
    """G(n, p) Erdős–Rényi undirected edge list (vectorized Bernoulli)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p
    return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int64)


def generate_unique_terminals(
    n: int, num_terminals: int = 3, seed: int | None = None
) -> List[int]:
    """``num_terminals`` distinct node ids."""
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.choice(n, size=num_terminals, replace=False)]


def generate_graph(
    n: int,
    d: int = 3,
    graph_type: str = "reg",
    p: float = 0.1,
    seed: int | None = None,
    num_terminals: int = 3,
) -> GraphSpec:
    """One graph with terminals: ``'reg'`` seeded d-regular,
    ``'reg_random'`` unseeded d-regular, ``'prob'``/``'erdos'`` G(n, p)."""
    if graph_type == "reg":
        edges = random_regular_edges(n, d, seed=seed)
        deg = d
    elif graph_type == "reg_random":
        edges = random_regular_edges(n, d, seed=None)
        deg = d
    elif graph_type in ("prob", "erdos"):
        edges = gnp_edges(n, p, seed=seed)
        deg = None
    else:
        raise ValueError(f"unknown graph_type {graph_type!r}")
    terminals = generate_unique_terminals(
        n, num_terminals, seed=None if seed is None else seed + 1
    )
    return GraphSpec(n_nodes=n, edges=edges, terminals=terminals, degree=deg)


def generate_graph_dataset(
    num_graphs: int,
    min_nodes: int,
    max_nodes: int,
    min_degree: int,
    max_degree: int,
    graph_type: str = "reg",
    num_terminals: int = 3,
    base_seed: int | None = None,
) -> Tuple[Dict[int, GraphSpec], Dict[int, List[int]]]:
    """Batch generation with random (n, d) per graph: n·d odd combinations
    are redrawn, within a budget of ``2·num_graphs`` attempts.  Returns
    ``(graphs, terminals)`` dicts keyed by graph index."""
    rng = np.random.default_rng(base_seed)
    graphs: Dict[int, GraphSpec] = {}
    terminals: Dict[int, List[int]] = {}
    attempts, max_attempts = 0, 2 * num_graphs
    i = 0
    while i < num_graphs and attempts < max_attempts:
        attempts += 1
        n = int(rng.integers(min_nodes, max_nodes + 1))
        d = int(rng.integers(min_degree, max_degree + 1))
        if graph_type in ("reg", "reg_random") and (n * d) % 2 != 0:
            continue
        seed = None if base_seed is None else base_seed + 1000 + i
        try:
            spec = generate_graph(
                n, d, graph_type, seed=seed, num_terminals=num_terminals
            )
        except RuntimeError:
            continue
        graphs[i] = spec
        terminals[i] = spec.terminals
        i += 1
    if i < num_graphs:
        raise RuntimeError(
            f"generated only {i}/{num_graphs} graphs in {max_attempts} attempts"
        )
    return graphs, terminals


def regular_graph_on_device(
    n: int, d: int, generator: torch.Generator, device: str | torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly d-regular circulant graph built on ``device``: d/2 distinct
    shifts o_k drawn from [1, n/2) with ``generator``, edges
    (i, (i + o_k) mod n) in both directions.  Returns directed COO
    ``(senders, receivers)``, int32 [n·d].  Port of the JAX package's
    generator of the same name; the shifts differ (another RNG), the
    structure is the same: no self-loops, no multi-edges.
    """
    if d % 2 != 0:
        raise ValueError("on-device generator requires even d")
    half = n // 2 - 1 if n % 2 == 0 else n // 2
    if d // 2 > half:
        raise ValueError(f"d={d} too large for distinct shifts with n={n}")
    shifts = 1 + torch.randperm(half, generator=generator, device=generator.device)[: d // 2]
    nodes = torch.arange(n, dtype=torch.int64, device=device)
    src = nodes.repeat(d // 2)
    dst = torch.cat([(nodes + int(s)) % n for s in shifts.tolist()])
    senders = torch.cat([src, dst]).to(torch.int32)
    receivers = torch.cat([dst, src]).to(torch.int32)
    return senders, receivers
