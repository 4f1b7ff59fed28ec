"""Plain reference of the giant configuration (``configs/giant-packed-10m.json``).

A two-layer GCN on the circulant d-regular graph of a job's seed (node i
joined to i ± s for each drawn shift s), written out in node order from
its description: a learned embedding [n, emb]; GraphConv norm='both' on a
regular graph, A·(X W)/d + b, emb → hidden → classes; softmax over the
classes; terminals (nodes 0, m, 2m with m = n / r) pinned to classes 0, 1,
2 and the straight-through argmax one-hot (every class equal to the row's
largest is set), each with identity gradient; the loss −(E − ½ ⟨S, A S⟩).
Aggregations take bfloat16 streams and sum in float32, forward and
backward, as the configuration states; everything else is float32, and
Adam keeps its first moment in bfloat16 and updates from (1 − b1)·g + b1·μ
as optax does, with b1·μ rounded to bfloat16.

The initial parameters arrive in the packed layout the configuration
states (the embedding as [n/r, r·emb], node u·m + j at row position
j·r + u); the reference reads them into node order itself.  Plain
PyTorch; it imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

LEAVES = ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")
B1, B2, EPS = 0.9, 0.999, 1e-8


def node_order(packed: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """[n/r, r·F] rows in the interleaved order → [n, F] in node order."""
    f = packed.numel() // n
    return packed.reshape(n // r, r, f).transpose(0, 1).reshape(n, f)


class Giant:
    def __init__(self, config: Dict, offsets: Sequence[int]):
        self.n, self.d, self.r = int(config["nodes"]), int(config["degree"]), int(config["r"])
        self.k = int(config["classes"])
        self.offsets = tuple(int(o) for o in offsets)
        self.stream = getattr(torch, config["aggregation_dtype"])
        self.mu_dtype = getattr(torch, config["adam_mu_dtype"])
        self.lr = float(config["learning_rate"])
        m = self.n // self.r
        self.terminals = torch.arange(self.k) * m

    def aggregate(self, x: torch.Tensor) -> torch.Tensor:
        """Σ_s x[(i + s) mod n] over the shifts, on a bfloat16 stream summed
        in float32."""
        xs = x.to(self.stream).float()
        y = torch.roll(xs, -self.offsets[0], dims=0)
        for o in self.offsets[1:]:
            y = y + torch.roll(xs, -o, dims=0)
        return y.to(self.stream).float()

    def loss(self, p: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = p["embed"] @ p["conv1.w"]
        h = torch.relu(self.aggregate(h) / self.d + p["conv1.b"])
        h = h @ p["conv2.w"][:, : self.k]
        h = self.aggregate(h) / self.d + p["conv2.b"][: self.k]
        probs = torch.softmax(h, dim=-1)
        t = self.terminals.to(probs.device)
        pin = torch.zeros_like(probs)
        pin[t] = (torch.eye(self.k, device=probs.device) - probs[t]).detach()
        pinned = probs + pin
        hard = (pinned >= pinned.amax(-1, keepdim=True)).float()
        s = (hard - pinned).detach() + pinned
        same = torch.dot(s.reshape(-1), self.aggregate(s).reshape(-1))
        return -(self.n * self.d // 2 - 0.5 * same)

    def train(self, params0: Dict[str, Dict[str, torch.Tensor]], steps: int) -> Dict[str, object]:
        """``steps`` Adam steps from ``params0`` (the packed JAX layout).
        Returns the loss before each step (``losses``), the first step's
        gradient norms
        (``first_grad``), the optimizer's gradient norms after the steps
        (``grad``) and the parameters' change (``change``).  Matmuls run in
        float32: TF32 is turned off."""
        torch.backends.cuda.matmul.allow_tf32 = False
        p = {f"{a}.{b}": params0[a][b].detach().float().clone()
             for a, b in (k.split(".") for k in LEAVES if k != "embed")}
        p["embed"] = node_order(params0["embed"].detach().float(), self.n, self.r).clone()
        start = {k: v.clone() for k, v in p.items()}
        for v in p.values():
            v.requires_grad_(True)
        mu = {k: torch.zeros_like(v, dtype=self.mu_dtype) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        out: Dict[str, object] = {"losses": []}
        for t in range(1, steps + 1):
            value = self.loss(p)
            grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
            out["losses"].append(float(value.detach()))
            if t == 1:
                out["first_grad"] = {k: float(g.double().norm()) for k, g in grads.items()}
            with torch.no_grad():
                for k, g in grads.items():
                    # optax's moments: (1 − b)·g + b·stored, b·stored in the
                    # stored dtype
                    m = (1 - B1) * g + B1 * mu[k]
                    nu[k] = (1 - B2) * (g * g) + B2 * nu[k]
                    p[k] -= self.lr * (m / (1 - B1 ** t)) / (torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
                    mu[k] = m.to(self.mu_dtype)
            del grads, value
        with torch.no_grad():
            out["change"] = {k: float((p[k] - start[k]).double().norm()) for k in p}
        return out
