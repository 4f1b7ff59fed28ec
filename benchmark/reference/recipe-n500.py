"""Plain reference of the recipe configuration (``configs/recipe-n500.json``).

The model of MJavaadAkhtar/GCN-max-cut's training recipe, written out
from its description: GCNSoftmax in → hidden → classes, each layer DGL's
GraphConv with norm='both' (D^-1/2 A D^-1/2 X W + b, no self-loops), on
the adjacency rows as ``width``-wide features; terminals 0..t-1 pinned to
their classes and the straight-through argmax one-hot, each with identity
gradient; the loss −½ Σ over directed edges (1 − ⟨s_u, s_v⟩); Adam (b1
0.9, b2 0.999, eps 1e-8, outside the root) stepped once a graph, in
order, as optax computes it.  The decode of ``test`` (``decode``): each
rollout samples every node's class by inverse CDF from a uniform (the
first class whose cumulative probability exceeds it, the last where none
does), terminals pinned; the best rollout is the first of the largest
cut; the refine climbs, by best-improvement single-node moves (the first
largest gain in row-major order over [node, class], taken while above
1e-6, at most ``max_steps`` moves), from the last three of a stable
ascending sort of the rollouts' cuts and from the argmax assignment, and
keeps the first of the largest cuts.  A decoded answer is also judged by
what it states (``answer_faults``): its cuts, its pinned terminals, and
its refined assignment a local optimum of single-node moves.

Dense PyTorch on the real nodes only, float32 with TF32 off; ``tf32``
turns TF32 on (the control).  It imports nothing of the program and
nothing of JAX, and takes nothing the program made.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b")
B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in float32 (TF32 off), or in TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class DenseGraph:
    """A graph as the reference holds it: the adjacency A [n, n], the
    normalised Â = D^-1/2 A D^-1/2, the features (A's rows padded with
    zeros to ``width`` columns) and the directed edge list."""

    def __init__(self, n: int, edges: np.ndarray, width: int, device):
        e = torch.as_tensor(np.asarray(edges), dtype=torch.int64, device=device)
        self.n, self.m = n, int(e.shape[0])
        self.src = torch.cat([e[:, 0], e[:, 1]])
        self.dst = torch.cat([e[:, 1], e[:, 0]])
        a = torch.zeros((n, n), dtype=torch.float32, device=device)
        a[self.src, self.dst] = 1.0
        self.A = a
        norm = torch.rsqrt(torch.clamp(a.sum(1), min=1.0))
        self.Ahat = norm[:, None] * a * norm[None, :]
        self.X = torch.nn.functional.pad(a, (0, width - n))

    def cut(self, asn: torch.Tensor) -> torch.Tensor:
        """Cut of each assignment [..., n]: edges whose ends differ."""
        return (asn[..., self.src] != asn[..., self.dst]).sum(-1) // 2


def forward(params: Dict[str, torch.Tensor], g: DenseGraph) -> torch.Tensor:
    """Class probabilities [n, k]."""
    h = torch.relu(g.Ahat @ (g.X @ params["conv1.w"]) + params["conv1.b"])
    h = g.Ahat @ (h @ params["conv2.w"]) + params["conv2.b"]
    return torch.softmax(h, dim=-1)


def straight_through(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    return (hard - soft).detach() + soft


def loss(params: Dict[str, torch.Tensor], g: DenseGraph, terminals: int) -> torch.Tensor:
    """The negative straight-through cut of the pinned argmax one-hot."""
    p = forward(params, g)
    k = p.shape[1]
    hard = p.detach().clone()
    hard[:terminals] = torch.eye(terminals, k, device=p.device, dtype=p.dtype)
    pinned = straight_through(hard, p)
    s = straight_through(
        torch.nn.functional.one_hot(pinned.argmax(-1), k).to(p.dtype), pinned)
    same = (s[g.src] * s[g.dst]).sum(-1)
    return -0.5 * torch.sum(1.0 - same)


class Adam:
    """Adam as optax computes it, on a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for k, g in grads.items():
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * (g * g) + B2 * self.nu[k]
            mhat = self.mu[k] / (1 - B1 ** self.t)
            vhat = self.nu[k] / (1 - B2 ** self.t)
            params[k] -= self.lr * mhat / (torch.sqrt(vhat) + EPS)


def leaves(params: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The JAX-layout tree's leaves under the reference's names, as float32
    copies that need gradients."""
    return {f"{a}.{b}": params[a][b].detach().float().clone().requires_grad_(True)
            for a, b in (k.split(".") for k in LEAVES)}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train(params0: Dict[str, Dict[str, torch.Tensor]], graphs: Sequence[DenseGraph],
          config: Dict, epochs: int, tf32: bool = False) -> Dict[str, object]:
    """``epochs`` epochs of per-graph steps from ``params0`` (JAX layout).
    Returns each epoch's summed loss (``losses``), the first step's
    gradient norms (``first_grad``), the parameters' change after the
    last epoch (``change``) and the parameters then (``params``, reference
    names).  The losses are read from the device once, at the end."""
    terminals = int(config["terminals"])
    with precision(tf32):
        p = leaves(params0)
        start = {k: v.detach().clone() for k, v in p.items()}
        opt = Adam(p, float(config["learning_rate"]))
        out: Dict[str, object] = {}
        losses = []
        for epoch in range(epochs):
            total = torch.zeros((), dtype=torch.float64, device=p["conv1.w"].device)
            for g in graphs:
                value = loss(p, g, terminals)
                grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
                if "first_grad" not in out:
                    out["first_grad"] = norms(grads)
                opt.step(p, grads)
                total += value.detach()
            losses.append(total)
        out["losses"] = [float(v) for v in losses]
        out["change"] = norms({k: p[k].detach() - start[k] for k in p})
        out["params"] = {k: v.detach() for k, v in p.items()}
    return out


@torch.no_grad()
def probabilities(params: Dict[str, torch.Tensor], g: DenseGraph, tf32: bool = False) -> torch.Tensor:
    """The probabilities of ``params`` (reference names) on ``g``."""
    with precision(tf32):
        return forward(params, g)


def answer_faults(edges: np.ndarray, n: int, k: int, terminals: int, answer: Dict) -> int:
    """How many of an answer's own statements fail, counted on the host: its
    refined and sampled cuts against the cuts of its assignments, its
    terminals pinned, the refined cut at least the sampled one, and the
    refined assignment a local optimum (no node's move to another class
    gains more than 1e-6)."""
    ref, post = np.asarray(answer["refined_assignment"]), np.asarray(answer["post_assignment"])
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = np.bincount(src * k + ref[dst], minlength=n * k).reshape(n, k)
    gain = w[np.arange(n), ref][:, None] - w
    gain[np.arange(n), ref] = 0
    pinned = list(range(terminals))
    return sum([
        assignment_cut(edges, ref) != answer["refined_cut"],
        assignment_cut(edges, post) != answer["post_cut"],
        list(ref[:terminals]) != pinned or list(post[:terminals]) != pinned,
        answer["refined_cut"] < answer["post_cut"],
        bool((gain[terminals:] > 1e-6).any()),
    ])


def assignment_cut(edges: np.ndarray, asn: np.ndarray) -> int:
    """Cut of one assignment of the real nodes, counted on the host."""
    return int(np.count_nonzero(asn[edges[:, 0]] != asn[edges[:, 1]]))


def uniforms(seed: int, samples: int, n_pad: int, device) -> torch.Tensor:
    """The rollouts' uniforms [samples, n_pad] as ``test`` draws them: one
    ``torch.rand`` of [samples, n_pad, 1] float32 from a fresh generator on
    ``device`` seeded with ``seed``, before any other draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((samples, n_pad, 1), generator=gen, dtype=torch.float32,
                      device=device)[:, :, 0]


def _cuts(edges: np.ndarray, asn: np.ndarray) -> np.ndarray:
    """Cuts of assignments [S, n]."""
    return np.count_nonzero(asn[:, edges[:, 0]] != asn[:, edges[:, 1]], axis=1)


def climb(edges: np.ndarray, n: int, k: int, terminals: int, start: np.ndarray,
          max_steps: int) -> np.ndarray:
    """Best-improvement single-node moves from ``start`` [n] until no move
    gains more than 1e-6 or ``max_steps`` moves."""
    asn = start.copy()
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    rows = np.arange(n)
    for _ in range(max_steps):
        w = np.bincount(src * k + asn[dst], minlength=n * k).reshape(n, k).astype(np.float64)
        gain = w[rows, asn][:, None] - w
        gain[rows, asn] = -np.inf
        gain[:terminals] = -np.inf
        flat = int(np.argmax(gain))
        if not gain.flat[flat] > 1e-6:
            break
        asn[flat // k] = flat % k
    return asn


def decode(probs: np.ndarray, u: np.ndarray, edges: np.ndarray, terminals: int,
           starts: int, max_steps: int = 500) -> Dict[str, object]:
    """The default decode of ``probs`` [n, k] (float32) with the rollouts'
    uniforms ``u`` [S, n]: ``post_cut``/``post_assignment`` (the best
    rollout) and ``refined_cut``/``refined_assignment`` (the best climb),
    counted on the host."""
    probs = np.asarray(probs, dtype=np.float32)
    n, k = probs.shape
    cdf = np.cumsum(probs, axis=1, dtype=np.float32)
    samples = np.minimum((u[:, :, None] >= cdf[None]).sum(-1), k - 1)
    fixed = np.arange(terminals)
    samples[:, :terminals] = fixed
    cuts = _cuts(edges, samples)
    best = int(np.argmax(cuts))
    simple = np.argmax(probs, axis=1)
    simple[:terminals] = fixed
    top = np.argsort(cuts, kind="stable")[-max(1, starts - 1):]
    climbed = np.stack([climb(edges, n, k, terminals, s, max_steps)
                        for s in list(samples[top]) + [simple]])
    rcuts = _cuts(edges, climbed)
    r = int(np.argmax(rcuts))
    return {"post_cut": int(cuts[best]), "post_assignment": samples[best],
            "refined_cut": int(rcuts[r]), "refined_assignment": climbed[r]}
