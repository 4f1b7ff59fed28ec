"""Plain reference of the plain-layout giant configuration
(``configs/giant-plain-10m.json``).

A two-layer GCN on the circulant d-regular graph of a job's seed (node i
joined to i ± s for each drawn shift s), written out in node order from
its description: a learned embedding [n, emb]; GraphConv norm='both' on a
d-regular graph, (A · ((X / √d) W)) / √d + b, projecting first (both
layers narrow: emb → hidden → classes), ReLU between; softmax over the
classes; nodes 0..k-1 pinned to classes 0..k-1 and the straight-through
argmax one-hot (ties to the lowest class), each with identity gradient;
the loss −(E − ½ ⟨S, A S⟩) with E = n·d/2.  Every aggregation is a sum of
``torch.roll`` over the shifts in float32, forward and backward (autograd
of the rolls).  Adam takes one step an epoch over conv1.w, conv1.b,
conv2.w, conv2.b and the embedding, with a float32 first moment, as optax
orders its moments.  Float32 throughout with TF32 off.

Departures from the description: none in the mathematics.  ``stream``
(the control) rounds each aggregation's input and output to that dtype,
forward and backward, with float32 sums: the packed configuration's
bfloat16 streams, one step below what this configuration states.

Plain PyTorch; it imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")
B1, B2, EPS = 0.9, 0.999, 1e-8


class Giant:
    """The model and loss on the graph of ``offsets``; ``stream`` (the
    control) is the dtype each aggregation's input and output is rounded
    to, or None for float32 throughout."""

    def __init__(self, config: Dict, offsets: Sequence[int], stream: torch.dtype | None = None):
        self.n, self.d = int(config["nodes"]), int(config["degree"])
        self.k = int(config["classes"])
        self.offsets = tuple(int(o) for o in offsets)
        self.norm = 1.0 / math.sqrt(float(self.d))
        self.lr = float(config["learning_rate"])
        self.stream = stream

    def aggregate(self, x: torch.Tensor) -> torch.Tensor:
        """(A x)[i] = Σ_s x[(i + s) mod n] over the shifts, summed in
        float32 (on ``stream``'s rounding where the control sets one)."""
        if self.stream is not None:
            x = x.to(self.stream).float()
        y = torch.roll(x, -self.offsets[0], dims=0)
        for o in self.offsets[1:]:
            y = y + torch.roll(x, -o, dims=0)
        return y if self.stream is None else y.to(self.stream).float()

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.aggregate((x * self.norm) @ w) * self.norm + b

    def loss(self, p: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = torch.relu(self.conv(p["embed"], p["conv1.w"], p["conv1.b"]))
        probs = torch.softmax(self.conv(h, p["conv2.w"], p["conv2.b"]), dim=-1)
        k = self.k
        pin = torch.zeros_like(probs)
        pin[:k] = (torch.eye(k, device=probs.device) - probs[:k]).detach()
        pinned = probs + pin
        hard = torch.nn.functional.one_hot(pinned.argmax(-1), k).to(pinned.dtype)
        s = (hard - pinned).detach() + pinned
        same = torch.dot(s.reshape(-1), self.aggregate(s).reshape(-1))
        return -(self.n * self.d // 2 - 0.5 * same)

    def train(self, params0: Dict[str, object], steps: int) -> Dict[str, object]:
        """``steps`` Adam steps from ``params0`` (``{"conv1": {"w", "b"},
        "conv2": {"w", "b"}, "embed": [n, emb]}``).  Returns the loss
        before each step (``losses``), the first step's gradients and their
        norms by leaf (``grad0``, ``first_grad``), the final parameters
        (``params``) and their change by leaf (``change``)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = {f"{a}.{b}": params0[a][b].detach().float().clone()
             for a, b in (k.split(".") for k in LEAVES if k != "embed")}
        p["embed"] = params0["embed"].detach().float().clone()
        start = {k: v.clone() for k, v in p.items()}
        for v in p.values():
            v.requires_grad_(True)
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        out: Dict[str, object] = {"losses": []}
        for t in range(1, steps + 1):
            value = self.loss(p)
            grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
            out["losses"].append(float(value.detach()))
            if t == 1:
                out["grad0"] = {k: g.detach().clone() for k, g in grads.items()}
                out["first_grad"] = {k: float(g.double().norm()) for k, g in grads.items()}
            with torch.no_grad():
                for k, g in grads.items():
                    mu[k] = (1 - B1) * g + B1 * mu[k]
                    nu[k] = (1 - B2) * (g * g) + B2 * nu[k]
                    p[k] -= self.lr * (mu[k] / (1 - B1 ** t)) / (
                        torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
            del grads, value
        with torch.no_grad():
            out["change"] = {k: float((p[k] - start[k]).double().norm()) for k in p}
        out["params"] = {k: v.detach() for k, v in p.items()}
        return out
