"""Node-sharded giant banded-graph trainers on the halo kernels.

Port of ``gcn_maxcut_tpu/parallel/giant_banded.py``.  The circulant d-regular
graph of ``bench/giant_demo.py`` (same offsets from the same seed) is node-
sharded contiguously over a ``parallel.mesh.Mesh``, and every aggregation
(two GCN convs and the cut loss's A·S, forward and backward) is a ring op of
``ops/halo.py``:

  * ``train_halo_giant``: node order, K5 with unit weights
    (``halo_banded_spmm_unit``), at the JAX trainer's widths and with its
    projection order (``_halo_conv``), so the 128 → 3 layer aggregates at
    width 128;
  * ``train_halo_giant_packed``: the interleaved node order of
    ``train_banded_giant_packed``, every aggregation on K6
    (``halo_banded_spmm_unit_packed``) over [n_shard, 16] shards, classes
    padded 3 → 16.

Conv parameters live on the first mesh device; each shard uses
``p.to(its device)``, so autograd sums their gradients over the shards (the
JAX ``psum``).  Embeddings and their Adam moments stay on their shards.
The loss is the sum of the per-shard losses, −(E − ½·Σ_c ⟨s_c, (A s)_c⟩),
with one backward, so both trainers take the true global gradient.  Epochs
run in chunks of ``epochs_per_call`` (``train/chunks.py``; on a ring of one
card, one captured CUDA graph replayed an epoch at a time).  (The
JAX plain trainer differentiates through a ``psum``, which scales its
embedding gradients by the device count; Adam hides that factor up to its
eps.)  Terminals are the first k nodes of shard 0.  ``params`` takes the
JAX layout (``convert.params_from_jax``): the conv parameters and the
global embedding ([n, emb], or packed [n/r, r·emb]), split into contiguous
shards as JAX shards it.  By default they are drawn from ``seed`` as the
single-chip trainers draw theirs, on the first mesh device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List

import torch

from gcn_maxcut_tpu_torch.bench.giant_demo import (
    G,
    _result,
    _train,
    circulant_offsets,
    group_argmax,
    group_onehot,
    group_softmax,
    packed_params,
    pin_group_head,
    plain_params,
)
from gcn_maxcut_tpu_torch.ops.halo import (
    halo_banded_spmm_unit,
    halo_banded_spmm_unit_packed,
)
from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, make_mesh
from gcn_maxcut_tpu_torch.train.chunks import chunk_sizes
from gcn_maxcut_tpu_torch.train.optim import Adam


@dataclasses.dataclass(frozen=True)
class HaloGiantConfig:
    d: int = 8
    num_classes: int = 3
    dim_embedding: int = 128
    hidden_dim: int = 128
    learning_rate: float = 1e-3
    epochs: int = 40
    epochs_per_call: int = 10       # epochs a chunk; epochs round up to whole chunks
    bandwidth: int = 63
    block: int = 1024
    seed: int = 0
    axis: str = "graph"


@dataclasses.dataclass(frozen=True)
class PackedHaloGiantConfig:
    d: int = 8
    num_classes: int = 3
    dim_embedding: int = 32
    learning_rate: float = 1e-3
    epochs: int = 40
    epochs_per_call: int = 10       # epochs a chunk; epochs round up to whole chunks
    bandwidth: int = 63
    r: int = 8                      # interleave factor
    seed: int = 0
    axis: str = "graph"
    agg_dtype: str | None = "bfloat16"  # aggregation streams (f32 sums)
    mu_dtype: str | None = "bfloat16"   # Adam's stored first moment
    act_dtype: str | None = None        # bf16 activations (opt-in)


def _place(
    params: Dict[str, Any], mesh: Mesh, rows: int
) -> tuple[Dict[str, Dict[str, torch.Tensor]], List[torch.Tensor]]:
    """Conv parameters on the first mesh device and the embedding cut into
    ``rows``-row contiguous shards, one on each device: fresh leaves."""
    dev0 = mesh.devices[0]
    conv = {name: {k: t.to(dev0).clone().requires_grad_(True)
                   for k, t in params[name].items()}
            for name in ("conv1", "conv2")}
    embed = params["embed"]
    if embed.shape[0] != rows * mesh.size:
        raise ValueError(f"embedding has {embed.shape[0]} rows, need "
                         f"{rows} x {mesh.size} shards")
    embeds = [embed[c * rows:(c + 1) * rows].to(dev).clone().requires_grad_(True)
              for c, dev in enumerate(mesh.devices)]
    return conv, embeds


def _run(loss_fn, conv, embeds, config, mesh, n, offsets, layout, mu_dtype=None):
    """Train every leaf with Adam in chunks of ``config.epochs_per_call``
    epochs, ``config.epochs`` rounded up to whole chunks as in the JAX
    trainers; the result keys of the JAX trainers and of
    ``bench/giant_demo.py``."""
    leaves = [conv["conv1"]["w"], conv["conv1"]["b"], conv["conv2"]["w"],
              conv["conv2"]["b"], *embeds]
    optimizer = Adam(leaves, config.learning_rate, mu_dtype=mu_dtype)
    chunks = chunk_sizes(0, config.epochs, config.epochs_per_call)
    t0 = time.perf_counter()
    history, first, steady = _train(loss_fn, leaves, optimizer, mesh.devices, chunks)
    res = _result(n, config.d, sum(chunks), history, first, steady, layout, offsets)
    res.update(num_devices=mesh.size, total_time_s=time.perf_counter() - t0)
    return res


def train_halo_giant(
    n_shard: int,
    config: HaloGiantConfig = HaloGiantConfig(),
    mesh: Mesh | None = None,
    params: Dict[str, Any] | None = None,
    return_assignment: bool = False,
) -> Dict[str, Any]:
    """Train on an (n_shard × mesh size)-node circulant graph, every
    aggregation on K5.  ``params``: ``{"conv1": {"w": [emb, hidden], "b"},
    "conv2": {"w": [hidden, classes], "b"}, "embed": [n, emb]}``.
    ``return_assignment`` adds the decoded class of every node."""
    mesh = mesh or make_mesh((config.axis,))
    n = n_shard * mesh.size
    k = config.num_classes
    offsets = circulant_offsets(config.d, config.bandwidth, config.seed)
    if params is None:
        params = plain_params(n, config.dim_embedding, config.hidden_dim, k,
                              config.seed, mesh.devices[0])
    conv, embeds = _place(params, mesh, n_shard)
    norm = 1.0 / math.sqrt(float(config.d))
    e_total = n * config.d / 2.0

    def agg(hs):
        return halo_banded_spmm_unit(hs, offsets, mesh, config.block)

    def conv_layer(p, xs):
        w = [p["w"].to(dev) for dev in mesh.devices]
        b = [p["b"].to(dev) for dev in mesh.devices]
        in_f, out_f = p["w"].shape
        in_al, out_al = in_f % 128 == 0, out_f % 128 == 0
        project_first = (out_f < in_f) if in_al == out_al else out_al
        hs = [x * norm for x in xs]
        if project_first:
            hs = agg([h @ wc for h, wc in zip(hs, w)])
        else:
            hs = [h @ wc for h, wc in zip(agg(hs), w)]
        return [h * norm + bc for h, bc in zip(hs, b)]

    def pinned_probs():
        hs = [torch.relu(h) for h in conv_layer(conv["conv1"], embeds)]
        probs = [torch.softmax(h, dim=-1) for h in conv_layer(conv["conv2"], hs)]
        return [pin_terminals(probs[0]), *probs[1:]]

    def loss_fn():
        s = [ste_argmax_onehot(p) for p in pinned_probs()]
        same = sum(torch.dot(a.reshape(-1), b.reshape(-1)).to(mesh.devices[0])
                   for a, b in zip(s, agg(s)))
        return -(e_total - 0.5 * same)

    res = _run(loss_fn, conv, embeds, config, mesh, n, offsets, "plain")
    if return_assignment:
        with torch.no_grad():
            res["assignment"] = torch.cat(
                [torch.argmax(p, dim=-1).cpu() for p in pinned_probs()]
            ).to(torch.int32).numpy()
    return res


def train_halo_giant_packed(
    n_shard: int,
    config: PackedHaloGiantConfig = PackedHaloGiantConfig(),
    mesh: Mesh | None = None,
    params: Dict[str, Any] | None = None,
    return_assignment: bool = False,
) -> Dict[str, Any]:
    """The packed trainer of ``train_banded_giant_packed`` node-sharded over
    the mesh, every aggregation on K6; ``n_shard % r == 0``.  ``params``:
    ``{"conv1": {"w": [emb, 16], "b"}, "conv2": {"w": [16, 16], "b"},
    "embed": [n/r, r·emb]}`` (the JAX layout).  ``return_assignment`` adds
    the decoded class of every node, in node order."""
    r, k = config.r, config.num_classes
    if k > G or k > r:
        raise ValueError(f"need num_classes <= {min(G, r)}")
    if config.dim_embedding % G:
        raise ValueError("dim_embedding must be a multiple of 16")
    if n_shard % r:
        raise ValueError(f"n_shard={n_shard} must be a multiple of r={r}")
    mesh = mesh or make_mesh((config.axis,))
    n = n_shard * mesh.size
    m_shard = n_shard // r
    emb = config.dim_embedding
    offsets = circulant_offsets(config.d, config.bandwidth, config.seed)
    act = torch.float32 if config.act_dtype is None else getattr(torch, config.act_dtype)
    agg = None if config.agg_dtype is None else getattr(torch, config.agg_dtype)
    inv_d = 1.0 / config.d
    e_total = n * config.d / 2.0
    if params is None:
        params = packed_params(n, r, emb, config.seed, mesh.devices[0])
    conv, embeds = _place(params, mesh, m_shard)
    class_ok = {dev: (torch.arange(G, device=dev) < k).to(act) for dev in mesh.devices}
    # terminals: positions 0..k-1 of shard 0 (nodes 0, m, 2m)
    term_onehot = torch.eye(G, device=mesh.devices[0], dtype=act)[:k]

    def spmm(hs):
        if agg is not None and act == torch.float32:
            hs = [h.to(agg) for h in hs]
        out = halo_banded_spmm_unit_packed(hs, offsets, r, mesh)
        return [h.to(act) for h in out]

    def layer(p, hs, relu):
        w = [p["w"].to(dev).to(act) for dev in mesh.devices]
        b = [p["b"].to(dev).to(act) for dev in mesh.devices]
        hs = spmm([h @ wc for h, wc in zip(hs, w)])
        hs = [h * inv_d + bc for h, bc in zip(hs, b)]
        return [torch.relu(h) for h in hs] if relu else hs

    def pinned_probs():
        hs = [e.view(n_shard, emb).to(act) for e in embeds]
        hs = layer(conv["conv2"], layer(conv["conv1"], hs, True), False)
        probs = [group_softmax(h, class_ok[h.device]) for h in hs]
        return [pin_group_head(probs[0], term_onehot), *probs[1:]]

    def loss_fn():
        s = [group_onehot(p, class_ok[p.device]) for p in pinned_probs()]
        same = sum(torch.dot(a.to(torch.float32).reshape(-1),
                             b.to(torch.float32).reshape(-1)).to(mesh.devices[0])
                   for a, b in zip(s, spmm(s)))
        return -(e_total - 0.5 * same)

    mu = None if config.mu_dtype is None else getattr(torch, config.mu_dtype)
    res = _run(loss_fn, conv, embeds, config, mesh, n, offsets, "packed", mu)
    if return_assignment:
        with torch.no_grad():
            cls = torch.cat([group_argmax(p, class_ok[p.device]).cpu()
                             for p in pinned_probs()])        # position order
            res["assignment"] = (
                cls.view(n // r, r).T.reshape(n).to(torch.int32).numpy()
            )
    return res
