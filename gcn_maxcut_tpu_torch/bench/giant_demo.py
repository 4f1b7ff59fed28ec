"""Single-device giant-graph trainers on a circulant regular graph.

Port of ``gcn_maxcut_tpu/bench/giant_demo.py``.  The graph is the circulant
d-regular graph whose shifts ``±o`` are drawn with
``np.random.default_rng(seed)`` exactly as the JAX package draws them, so
one seed gives one graph in both.  Every aggregation is the banded SpMM of
``ops/banded.py`` (the hand-written CUDA kernel on the card):

  * ``train_banded_giant``: node order, the kernel at r = 1 (K2) on the
    16-wide hidden and 3-wide class arrays;
  * ``train_banded_giant_packed``: interleaved node order throughout (node
    u·m + j at position j·r + u), the kernel on the [m, r·16] view (K3),
    classes padded 3 → 16 with a lane mask so every aggregated row is 16
    wide.  Its GEMMs are ``h.view(n, F_in) @ W`` on the packed order.

The loss is the negative hard cut ``−(E − ½⟨S, A S⟩)`` of the straight-
through one-hot assignment S, so each epoch runs three aggregations forward
and three backward (the adjoint is the kernel with negated offsets).
Optimisation is Adam (``train/optim.py``), optionally with a bfloat16 first
moment.  Both trainers take initial parameters in the JAX layout
(``convert.params_from_jax``) through ``params=``; by default they are
drawn from ``seed`` with a ``torch.Generator``.  Checkpoint and resume are
not ported yet.

Epoch time is the mean over the epochs after the first (which includes the
kernel build and warm-up), from CUDA events on the card and the host clock
on the CPU.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.models.gcn import gcn_conv_init
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm_unit, banded_spmm_unit_packed
from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.train.optim import Adam

G = 16  # lane-group width of the packed layout (classes padded to it)


def circulant_offsets(d: int, bandwidth: int, seed: int) -> tuple[int, ...]:
    """The d shifts ``(s1, -s1, s2, -s2, ...)``, drawn as the JAX package
    draws them."""
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    return tuple(int(o) for s in half for o in (s, -s))


def _init_params(
    n_rows: int, row_width: int, in_out: List[tuple[int, int]], seed: int,
    dev: torch.device,
) -> Dict[str, Any]:
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {
        f"conv{i + 1}": gcn_conv_init(a, b, gen, dev)
        for i, (a, b) in enumerate(in_out)
    }
    params["embed"] = torch.randn(
        (n_rows, row_width), generator=gen, device=dev) * 0.1
    return params


def plain_params(
    n: int, dim_embedding: int = 32, hidden_dim: int = 16, num_classes: int = 3,
    seed: int = 0, device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Initial parameters of ``train_banded_giant``, drawn from ``seed``."""
    return _init_params(
        n, dim_embedding, [(dim_embedding, hidden_dim), (hidden_dim, num_classes)],
        seed, resolve_device(device),
    )


def packed_params(
    n: int, r: int = 8, dim_embedding: int = 32, seed: int = 0,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Initial parameters of ``train_banded_giant_packed`` (classes padded
    to 16, the embedding as the packed [n/r, r·emb] table), drawn from
    ``seed``."""
    return _init_params(
        n // r, r * dim_embedding, [(dim_embedding, G), (G, G)], seed,
        resolve_device(device),
    )


def _leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [params["conv1"]["w"], params["conv1"]["b"],
            params["conv2"]["w"], params["conv2"]["b"], params["embed"]]


def _train(
    loss_fn: Callable[[Dict[str, Any]], torch.Tensor],
    params: Dict[str, Any],
    epochs: int,
    optimizer: Adam,
    dev: torch.device,
) -> tuple[List[float], float, float]:
    """Run ``epochs`` Adam steps; returns (loss history, first-epoch
    seconds, mean seconds of the later epochs)."""
    leaves = _leaves(params)

    def step() -> torch.Tensor:
        loss = loss_fn(params)
        optimizer.step(torch.autograd.grad(loss, leaves))
        return loss.detach()

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    losses = [step()]
    if cuda:
        torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    if epochs > 1:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        losses += [step() for _ in range(epochs - 1)]
        if cuda:
            end.record()
            end.synchronize()
            steady = start.elapsed_time(end) / 1e3 / (epochs - 1)
        else:
            steady = (time.perf_counter() - t0) / (epochs - 1)
    else:
        steady = first
    history = [float(v) for v in torch.stack(losses).cpu()]
    return history, first, steady


def _result(n, d, epochs, history, first, steady, layout, offsets):
    e_undirected = n * d // 2
    final_cut = -history[-1]
    return {
        "n": n,
        "d": d,
        "edges": e_undirected,
        "epochs": epochs,
        "first_epoch_s": first,
        "epoch_time_s": steady,
        "edges_per_s_per_epoch": n * d / steady,
        "initial_cut": -history[0],
        "final_cut": final_cut,
        "cut_fraction": final_cut / e_undirected,
        "layout": layout,
        "offsets": list(offsets),
        "history": history,
    }


def train_banded_giant(
    n: int = 10_002_432,
    d: int = 8,
    dim_embedding: int = 32,
    hidden_dim: int = 16,
    num_classes: int = 3,
    learning_rate: float = 1e-3,
    epochs: int = 50,
    bandwidth: int = 63,
    seed: int = 0,
    params: Dict[str, Any] | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Two-layer banded GCN in node order (the kernel at r = 1); returns the
    cut and the epoch throughput.  ``params``: ``{"conv1": {"w": [emb,
    hidden], "b"}, "conv2": {"w": [hidden, classes], "b"}, "embed": [n,
    emb]}``."""
    dev = resolve_device(device)
    offsets = circulant_offsets(d, bandwidth, seed)
    e_undirected = n * d // 2
    if params is None:
        params = plain_params(n, dim_embedding, hidden_dim, num_classes, seed, dev)
    params = {k: ({n_: t.to(dev).clone() for n_, t in v.items()}
                  if isinstance(v, dict) else v.to(dev).clone())
              for k, v in params.items()}
    for t in _leaves(params):
        t.requires_grad_(True)
    norm = 1.0 / math.sqrt(float(d))

    def conv(p, x):
        h = x * norm
        if p["w"].shape[0] > p["w"].shape[1]:
            h = banded_spmm_unit(h @ p["w"], offsets)
        else:
            h = banded_spmm_unit(h, offsets) @ p["w"]
        return h * norm + p["b"]

    def loss_fn(p):
        h = torch.relu(conv(p["conv1"], p["embed"]))
        probs = torch.softmax(conv(p["conv2"], h), dim=-1)
        onehot = ste_argmax_onehot(pin_terminals(probs))
        same = torch.dot(onehot.reshape(-1), banded_spmm_unit(onehot, offsets).reshape(-1))
        return -(e_undirected - 0.5 * same)

    optimizer = Adam(_leaves(params), learning_rate)
    history, first, steady = _train(loss_fn, params, epochs, optimizer, dev)
    return _result(n, d, epochs, history, first, steady, "plain", offsets)


def train_banded_giant_packed(
    n: int = 10_002_432,
    d: int = 8,
    dim_embedding: int = 32,
    hidden_dim: int = 16,
    num_classes: int = 3,
    learning_rate: float = 1e-3,
    epochs: int = 50,
    bandwidth: int = 63,
    r: int = 8,
    seed: int = 0,
    agg_dtype: str | None = "bfloat16",
    act_dtype: str | None = None,
    mu_dtype: str | None = "bfloat16",
    return_assignment: bool = False,
    params: Dict[str, Any] | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Banded GCN training with every array in interleaved node order and
    every aggregation on the packed kernel.

    ``agg_dtype="bfloat16"`` streams the aggregations (forward and
    backward) in bfloat16 with float32 sums in the kernel; None keeps
    float32 streams.  ``mu_dtype="bfloat16"`` stores Adam's first moment in
    bfloat16.  ``act_dtype="bfloat16"`` runs the activations (GEMMs, head,
    cotangents) in bfloat16 with float32 parameters and a float32 loss
    reduction.  ``params``: ``{"conv1": {"w": [emb, 16], "b"}, "conv2":
    {"w": [16, 16], "b"}, "embed": [n/r, r·emb]}`` (the JAX layout).
    ``return_assignment`` adds the decoded class of every node, in node
    order.
    """
    if hidden_dim != G or dim_embedding % G:
        raise ValueError("packed trainer expects hidden_dim=16, emb % 16 == 0")
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    dev = resolve_device(device)
    act = torch.float32 if act_dtype is None else getattr(torch, act_dtype)
    agg = None if agg_dtype is None else getattr(torch, agg_dtype)
    m = n // r
    offsets = circulant_offsets(d, bandwidth, seed)
    e_undirected = n * d // 2
    inv_d = 1.0 / d
    if params is None:
        params = packed_params(n, r, dim_embedding, seed, dev)
    params = {k: ({n_: t.to(dev).clone() for n_, t in v.items()}
                  if isinstance(v, dict) else v.to(dev).clone())
              for k, v in params.items()}
    for t in _leaves(params):
        t.requires_grad_(True)

    class_ok = (torch.arange(G, device=dev) < num_classes).to(act)     # [16]
    # terminals: positions 0..k-1 (nodes 0, m, 2m), pinned to their own class
    term_onehot = torch.eye(G, device=dev, dtype=act)[:num_classes]

    def spmm(h):
        if agg is not None and act == torch.float32:
            h = h.to(agg)
        return banded_spmm_unit_packed(h, offsets, r).to(act)

    def pinned_probs(p):
        h = p["embed"].view(n, dim_embedding).to(act) @ p["conv1"]["w"].to(act)
        h = torch.relu(spmm(h) * inv_d + p["conv1"]["b"].to(act))
        h = h @ p["conv2"]["w"].to(act)
        h = spmm(h) * inv_d + p["conv2"]["b"].to(act)
        # masked softmax over the k real classes of each 16-lane group; the
        # max is a shift and carries no gradient
        gmax = (h + (class_ok - 1.0) * 1e9).amax(dim=-1, keepdim=True).detach()
        e = torch.exp(h - gmax) * class_ok
        probs = e / e.sum(dim=-1, keepdim=True)
        head = probs[:num_classes]
        return torch.cat([(term_onehot - head).detach() + head, probs[num_classes:]])

    def loss_fn(p):
        pinned = pinned_probs(p)
        # straight-through group argmax: every lane equal to the group max
        # is set (ties set several lanes, as in the JAX trainer)
        gmax = pinned.amax(dim=-1, keepdim=True)
        hard = ((pinned >= gmax).to(act) * class_ok).detach()
        onehot = (hard - pinned).detach() + pinned
        same = torch.dot(
            onehot.to(torch.float32).reshape(-1),
            spmm(onehot).to(torch.float32).reshape(-1),
        )
        return -(e_undirected - 0.5 * same)

    optimizer = Adam(
        _leaves(params), learning_rate,
        mu_dtype=None if mu_dtype is None else getattr(torch, mu_dtype),
    )
    history, first, steady = _train(loss_fn, params, epochs, optimizer, dev)
    res = _result(n, d, epochs, history, first, steady, "packed", offsets)
    if return_assignment:
        with torch.no_grad():
            pinned = pinned_probs(params).float()
            masked = torch.where(class_ok > 0, pinned, -torch.inf)
            cls = torch.argmax(masked, dim=-1)                  # position order
            res["assignment"] = (
                cls.view(m, r).T.reshape(n).to(torch.int32).cpu().numpy()
            )
    return res
