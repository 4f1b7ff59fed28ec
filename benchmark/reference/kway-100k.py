"""Plain reference of the k-way configuration (``configs/kway-100k.json``).

A two-layer GCN on one graph, written out in node order from its
description: a learned embedding [n, emb]; GraphConv norm='both',
D^-1/2 A D^-1/2 (X W) + b with D the in-degrees (A·XW/d + b on a
d-regular graph), emb → hidden → k, each layer projecting first where its
width narrows; ReLU between; softmax over the k classes; nodes 0..k-1
pinned to classes 0..k-1 and the straight-through argmax one-hot (ties to
the lowest class), each with identity gradient; the loss
−(Σ_E w − ⟨S, A S⟩)/2 over the directed edges, unit weights.  Every
aggregation is an ``index_add_`` over the directed edges.  Adam takes one
step an epoch over conv1.w, conv1.b, conv2.w, conv2.b and the embedding
in optax's order.  Float32 throughout with TF32 off; ``tf32=True`` turns
it on (the control).

Plain PyTorch; it imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")
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


class KWay:
    """The model and loss on the graph of ``edges`` (undirected [m, 2] node
    pairs, each edge once; both directions are aggregated) with ``k``
    classes, on ``device``."""

    def __init__(self, edges: np.ndarray, n: int, k: int, learning_rate: float,
                 device: str | torch.device):
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
        self.src = torch.cat([e[:, 0], e[:, 1]])
        self.dst = torch.cat([e[:, 1], e[:, 0]])
        self.n, self.k, self.lr = int(n), int(k), float(learning_rate)
        deg = torch.zeros(self.n, device=device).index_add_(
            0, self.dst, torch.ones(self.dst.shape[0], device=device))
        self.norm = deg.clamp(min=1.0).rsqrt()[:, None]
        self.total_w = float(self.dst.shape[0])

    def aggregate(self, x: torch.Tensor) -> torch.Tensor:
        """(A x)[v] = Σ over directed edges (u → v) of x[u]."""
        return torch.zeros_like(x).index_add_(0, self.dst, x[self.src])

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h = x * self.norm
        h = self.aggregate(h @ w) if w.shape[0] > w.shape[1] else self.aggregate(h) @ w
        return h * self.norm + b

    def loss(self, p: Dict[str, torch.Tensor]) -> tuple:
        """The loss and the softmax probabilities [n, k] before pinning."""
        h = torch.relu(self.conv(p["embed"], p["conv1.w"], p["conv1.b"]))
        probs = torch.softmax(self.conv(h, p["conv2.w"], p["conv2.b"]), dim=-1)
        k = self.k
        pin = torch.zeros_like(probs)
        pin[:k] = (torch.eye(k, device=probs.device) - probs[:k]).detach()
        pinned = probs + pin
        hard = torch.nn.functional.one_hot(pinned.argmax(-1), k).to(pinned.dtype)
        s = (hard - pinned).detach() + pinned
        return -(self.total_w - torch.sum(s * self.aggregate(s))) / 2.0, probs

    def train(self, params0: Dict, steps: int, tf32: bool = False) -> Dict[str, object]:
        """``steps`` Adam steps from ``params0`` (``conv1``/``conv2`` dicts of
        ``w`` [in, out] and ``b``, ``embed`` [..., emb] whose rows in order
        are the nodes in order).  Returns the loss before each step
        (``losses``), the first forward's probabilities before pinning
        (``probs0``), the first step's gradient norms (``first_grad``) and
        the parameters' change after the steps (``change``), by leaf; and,
        by leaf, the first gradient (``grad0``) and the final parameters
        (``params``)."""
        def leaf(x):
            return torch.as_tensor(x).detach().to(self.src.device, torch.float32).clone()

        p = {f"{a}.{b}": leaf(params0[a][b]) for a, b in (n.split(".") for n in LEAVES[:4])}
        p["embed"] = leaf(params0["embed"]).reshape(self.n, -1)
        start = {n: v.clone() for n, v in p.items()}
        for v in p.values():
            v.requires_grad_(True)
        mu = {n: torch.zeros_like(v) for n, v in p.items()}
        nu = {n: torch.zeros_like(v) for n, v in p.items()}
        out: Dict[str, object] = {"losses": []}
        with precision(tf32):
            for t in range(1, steps + 1):
                value, probs = self.loss(p)
                grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
                out["losses"].append(float(value.detach()))
                if t == 1:
                    out["probs0"] = probs.detach()
                    out["first_grad"] = {n: float(g.double().norm()) for n, g in grads.items()}
                    out["grad0"] = {n: g.detach().clone() for n, g in grads.items()}
                with torch.no_grad():
                    for n, g in grads.items():
                        mu[n] = (1 - B1) * g + B1 * mu[n]
                        nu[n] = (1 - B2) * (g * g) + B2 * nu[n]
                        p[n] -= self.lr * (mu[n] / (1 - B1 ** t)) / (
                            torch.sqrt(nu[n] / (1 - B2 ** t)) + EPS)
                del grads, value, probs
        with torch.no_grad():
            out["change"] = {n: float((p[n] - start[n]).double().norm()) for n in p}
            out["params"] = {n: v.detach() for n, v in p.items()}
        return out
