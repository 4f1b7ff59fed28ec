"""Giant-graph training: one node-sharded graph over a device ring.

Port of ``gcn_maxcut_tpu/parallel/giant.py`` (BASELINE config 4: one large
regular graph, k terminals).  An epoch, on a ``parallel.mesh.Mesh``:

  * features: per-shard embedding rows ``[n_shard, F]`` (trained);
  * 2× ``spmm.sharded_gcn_conv`` on the ring (or all-gather) schedule with
    the symmetric backward, ReLU between, softmax head;
  * terminal pinning on shard 0's rows 0..k-1 and the straight-through
    argmax;
  * the loss −cut, ``spmm.sharded_cut_edgeform`` on the same schedule;
  * one backward for the true global gradient of every leaf and one Adam
    step (``train/optim.Adam``, optax's order).

``make_giant_step`` runs ``epochs_per_call`` such epochs a call: on a ring
of one card, one captured CUDA graph replayed an epoch at a time, the
losses read once (``train/chunks.py``).

The conv parameters live on the first mesh device and each shard uses its
copy (autograd sums their gradients: the JAX ``pmean`` of ``psum``-scaled
shares).  The JAX step differentiates a loss that holds a ``psum``, so its
embedding gradient is the device count times the true one; Adam hides
that factor up to its eps.  Initial parameters are numpy draws from
``config.seed`` (``bench.locality.locality_params``), or the caller's in
the JAX layout (``params``: ``{"conv1", "conv2", "embed": [D, n_shard,
F]}``), so both packages can start from one draw.  Checkpoints use the JAX
package's npz keys, so each package resumes the other's.

Under a profiler session ``train_giant_graph`` records the spans
``sharded.partition`` (node -> shard), ``sharded.assemble`` (the shards'
tables and their move to the mesh), ``sharded.setup`` (the parameters'
placement, Adam's state and the chunk callable) and ``sharded.decode``
(the final forward and its host copy), ``utils/profiling.py``; the
epochs' spans are the chunk runner's ``chunk.*``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, make_mesh
from gcn_maxcut_tpu_torch.parallel.partition import (
    ShardedGraph,
    partition_nodes_bfs,
    partition_nodes_metis,
    shard_graph,
)
from gcn_maxcut_tpu_torch.parallel.spmm import Blocks, sharded_cut_edgeform, sharded_gcn_conv
from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gcn_maxcut_tpu_torch.train.chunks import chunk_step
from gcn_maxcut_tpu_torch.train.optim import Adam
from gcn_maxcut_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GiantConfig:
    num_classes: int = 3
    dim_embedding: int = 128
    hidden_dim: int = 64
    learning_rate: float = 1e-3
    number_epochs: int = 200
    schedule: str = "ring"           # ring | allgather
    seed: int = 0
    log_every: int = 20
    epochs_per_call: int = 1         # epochs a chunk (one host read); epochs
                                     # round up to whole chunks
    partition: str = "contiguous"    # contiguous | bfs | metis (node -> shard)
    local_reorder: str = "off"       # off | rcm (band each shard's local subgraph)
    block_ell: bool = False          # hop-0 aggregation on K1 where every shard bands
    block_ell_outlier_frac: float = 0.05  # the planner's outlier budget


def sharded_cut(sg: ShardedGraph, ss: Blocks, mesh: Mesh) -> torch.Tensor:
    """Relaxed cut Σ_E w·(1 − ⟨s_u, s_v⟩)/2 scored edge group by edge group:
    at hop h shard d scores group h against shard (d + h) mod D's rows, the
    block the ring delivers then.  The full-graph scalar, on the first mesh
    device."""
    D = mesh.size
    totals = []
    for d, dev in enumerate(mesh.devices):
        total = torch.zeros((), device=dev)
        for h in range(D):
            su = ss[(d + h) % D].to(dev)[sg.senders[d][h]]
            sv = ss[d][sg.receivers[d][h]]
            same = torch.sum(su * sv, dim=-1)
            m = sg.edge_mask[d][h]
            total = total + torch.sum(sg.weights[d][h] * m * (m - same * m))
        totals.append(total.to(mesh.devices[0]))
    return sum(totals) / 2.0


def _pin_and_ste(probs: Blocks, k: int) -> Blocks:
    """Terminal pinning (shard 0 rows 0..k-1) and the straight-through argmax."""
    return [ste_argmax_onehot(pin_terminals(p, k) if d == 0 else p) for d, p in enumerate(probs)]


def _forward(conv: Dict[str, Any], embeds: Blocks, sg: ShardedGraph, mesh: Mesh,
             config: GiantConfig) -> Blocks:
    h = sharded_gcn_conv(conv["conv1"]["w"], conv["conv1"]["b"], sg, embeds, mesh,
                         config.schedule)
    h = sharded_gcn_conv(conv["conv2"]["w"], conv["conv2"]["b"], sg,
                         [torch.relu(x) for x in h], mesh, config.schedule)
    return _pin_and_ste([torch.softmax(x, dim=-1) for x in h], config.num_classes)


@dataclasses.dataclass
class GiantState:
    """Trained leaves (conv parameters on the first mesh device, one
    embedding block per shard) and their Adam state."""

    conv: Dict[str, Dict[str, torch.Tensor]]
    embeds: List[torch.Tensor]
    optimizer: Adam

    @classmethod
    def create(cls, params: Dict[str, Any], mesh: Mesh, learning_rate: float,
               mu_dtype: str | None = None) -> "GiantState":
        """From parameters in the JAX layout (numpy or tensors)."""
        return cls.from_blocks(params, mesh.devices, learning_rate, mu_dtype)

    @classmethod
    def from_blocks(cls, params: Dict[str, Any], devices, learning_rate: float,
                    mu_dtype: str | None = None) -> "GiantState":
        """From parameters in the JAX layout (numpy or tensors) with
        ``embed`` [len(devices), n_shard, F]: fresh float32 leaves, the
        conv parameters on ``devices[0]``, embedding block i on
        ``devices[i]`` (the hybrid trainer's blocks: every graph's shards,
        graph by graph), and their Adam state (``mu_dtype``: the first
        moment's dtype, by name; default float32)."""
        def leaf(x, dev) -> torch.Tensor:
            t = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))
            return t.to(dev, torch.float32).clone().requires_grad_(True)

        conv = {name: {k: leaf(t, devices[0]) for k, t in params[name].items()}
                for name in ("conv1", "conv2")}
        embed = params["embed"]
        if len(embed) != len(devices):
            raise ValueError(f"embedding of {len(embed)} blocks for {len(devices)} devices")
        embeds = [leaf(e, dev) for e, dev in zip(embed, devices)]
        state = cls(conv, embeds, None)
        state.optimizer = Adam(state.leaves(), learning_rate,
                               mu_dtype=None if mu_dtype is None else getattr(torch, mu_dtype))
        return state

    def leaves(self) -> List[torch.Tensor]:
        return [self.conv["conv1"]["w"], self.conv["conv1"]["b"],
                self.conv["conv2"]["w"], self.conv["conv2"]["b"], *self.embeds]

    def clone(self) -> "GiantState":
        """An independent copy: leaves, moments and step count."""
        conv = {name: {k: t.detach().clone().requires_grad_(True) for k, t in layer.items()}
                for name, layer in self.conv.items()}
        embeds = [e.detach().clone().requires_grad_(True) for e in self.embeds]
        state = GiantState(conv, embeds, None)
        opt = Adam(state.leaves(), self.optimizer.lr)
        opt.load(self.optimizer.count, self.optimizer.mu, self.optimizer.nu)
        state.optimizer = opt
        return state

    def _tree(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        """Per-leaf tensors in the optax layout of the (conv, embed) pair."""
        return {"0": {"conv1": {"w": leaves[0], "b": leaves[1]},
                      "conv2": {"w": leaves[2], "b": leaves[3]}},
                "1": torch.stack([t.detach().cpu() for t in leaves[4:]])}

    def opt_state(self) -> Dict[str, Any]:
        """Adam's state under the JAX package's optax paths."""
        opt = self.optimizer
        return {"0": {".count": torch.tensor(opt.count, dtype=torch.int32),
                      ".mu": self._tree(opt.mu), ".nu": self._tree(opt.nu)}}

    def embed(self) -> torch.Tensor:
        """The embedding as one [D, n_shard, F] host tensor."""
        return torch.stack([e.detach().cpu() for e in self.embeds])

    @torch.no_grad()
    def load(self, conv: Dict[str, Any], opt_state: Dict[str, Any], embed: torch.Tensor) -> None:
        for name, layer in self.conv.items():
            for k, t in layer.items():
                t.copy_(conv[name][k])
        for e, src in zip(self.embeds, embed):
            e.copy_(src)
        inner = opt_state["0"]

        def flat(tree):
            return [tree["0"]["conv1"]["w"], tree["0"]["conv1"]["b"],
                    tree["0"]["conv2"]["w"], tree["0"]["conv2"]["b"],
                    *tree["1"]]                     # [D, n_shard, F]: one block a shard

        self.optimizer.load(int(inner[".count"]), flat(inner[".mu"]), flat(inner[".nu"]))


def _loss(state: GiantState, sg: ShardedGraph, mesh: Mesh, config: GiantConfig) -> torch.Tensor:
    """The epoch's loss, −cut of the pinned straight-through assignment,
    on the first mesh device."""
    onehot = _forward(state.conv, state.embeds, sg, mesh, config)
    return -sharded_cut_edgeform(sg, onehot, mesh, config.schedule)


def _epoch(state: GiantState, sg: ShardedGraph, mesh: Mesh, config: GiantConfig) -> torch.Tensor:
    """One forward, backward and Adam step; the epoch's loss (before the
    update), on the first mesh device."""
    loss = _loss(state, sg, mesh, config)
    state.optimizer.step(torch.autograd.grad(loss, state.leaves()))
    return loss.detach()


def make_giant_step(
    sg: ShardedGraph, mesh: Mesh, config: GiantConfig, state: GiantState,
    max_chunk: int | None = None,
) -> Callable[..., np.ndarray]:
    """The chunk of the JAX ``make_giant_step``: ``chunk(k)`` runs k epochs
    (default ``config.epochs_per_call``, at most ``max_chunk``), each a
    forward, backward and Adam step updating ``state`` in place, and
    returns their losses (before each update) as a float32 host array,
    read once (``train/chunks.chunk_step``).  On one card the epochs are
    one captured CUDA graph replayed k times; ``chunk.runner`` is the
    ``ChunkRunner``.  One callable takes any k, as the JAX
    ``dynamic_epochs`` executable does."""
    return chunk_step(lambda: _loss(state, sg, mesh, config), state.leaves(),
                      state.optimizer, mesh.devices, config.epochs_per_call, max_chunk)


def decode_assignment(
    sg: ShardedGraph, mesh: Mesh, config: GiantConfig,
    conv: Dict[str, Any], embeds: Blocks,
) -> np.ndarray:
    """One sharded forward -> each node's class in the sharded layout
    ``[num_shards, n_shard]`` (global order through ``global_to_local``),
    with the training step's pinning."""
    with torch.no_grad():
        onehot = _forward(conv, embeds, sg, mesh, config)
        return torch.stack([torch.argmax(s, dim=-1).to(torch.int32).cpu()
                            for s in onehot]).numpy()


def measure_epoch_time(
    sg: ShardedGraph,
    mesh: Mesh,
    config: GiantConfig,
    state: GiantState,
    k_hi: int = 20,
    k_lo: int = 5,
    reps: int = 3,
) -> Dict[str, Any]:
    """Seconds an epoch from the difference of the best of ``reps`` chunks
    of ``k_hi`` and of ``k_lo`` epochs, which cancels the per-chunk
    overhead (the JAX package's amortized method): one chunk callable
    (``make_giant_step``) on a clone of ``state``, which is left as it
    was, each chunk ending in its host read.  A non-positive difference
    gives NaN with ``reliable`` False."""
    from gcn_maxcut_tpu_torch.bench.giant_demo import _synchronize  # bench imports this module

    trial = state.clone()
    step = make_giant_step(sg, mesh, config, trial, max_chunk=max(k_hi, k_lo))

    def run(k: int) -> float:
        _synchronize(mesh.devices)
        t0 = time.perf_counter()
        step(k)
        _synchronize(mesh.devices)
        return time.perf_counter() - t0

    run(k_lo)                                   # warm-up and capture
    times = {k: [run(k) for _ in range(reps)] for k in (k_hi, k_lo)}
    diff = min(times[k_hi]) - min(times[k_lo])
    reliable = diff > 0
    if not reliable:
        logger.warning("measure_epoch_time: best of %d chunks of %d epochs (%.4f s) is not "
                       "above that of %d epochs (%.4f s); returning NaN",
                       reps, k_hi, min(times[k_hi]), k_lo, min(times[k_lo]))
    return {
        "epoch_time_s": diff / (k_hi - k_lo) if reliable else float("nan"),
        "reliable": reliable,
        "k_hi": k_hi,
        "k_lo": k_lo,
        "reps": reps,
        "spread_hi_s": max(times[k_hi]) - min(times[k_hi]),
        "spread_lo_s": max(times[k_lo]) - min(times[k_lo]),
        "best_hi_s": min(times[k_hi]),
        "method": "difference of the best chunks of k_hi and k_lo epochs (host clock, "
                  "every mesh device synchronized)",
    }


def _partition(senders, receivers, n: int, num_shards: int, how: str) -> np.ndarray | None:
    if how == "bfs":
        return partition_nodes_bfs(senders, receivers, n, num_shards)
    if how == "metis":
        return partition_nodes_metis(senders, receivers, n, num_shards)
    if how != "contiguous":
        raise ValueError(f"unknown partition {how!r}")
    return None


def train_giant_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    config: GiantConfig = GiantConfig(),
    mesh: Mesh | None = None,
    measure_throughput: bool = False,
    return_assignment: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int | None = None,
    resume_from: str | None = None,
    params: Dict[str, Any] | None = None,
) -> Dict[str, Any]:
    """Partition -> assemble the shards -> train -> decoded cut value.

    ``mesh``: default every CUDA device (raises without CUDA); a mesh of
    CPU devices runs on the CPU.  ``measure_throughput`` adds
    ``measure_epoch_time``'s amortized numbers; ``return_assignment`` adds
    the decoded class of every node in global order.  Checkpoints (the
    JAX package's npz layout: conv parameters, the [D, n_shard, F]
    embedding, Adam's state) are written every ``checkpoint_every`` epochs
    and at the end; ``resume_from`` continues from one.  A resume at or
    past ``number_epochs`` runs no epoch and returns the checkpoint's last
    logged loss; ``edges_per_s`` counts only the epochs this call ran,
    without the first chunk (which pays the kernels' build and the
    capture) when more than one ran, or NaN when none ran.  Epochs run in
    chunks of ``config.epochs_per_call`` (``make_giant_step``), so
    ``number_epochs`` rounds up to whole chunks and checkpoints fall on
    chunk boundaries (``checkpoint_every`` rounded down to whole chunks),
    as in the JAX trainer.
    """
    from gcn_maxcut_tpu_torch.bench.giant_demo import _synchronize  # bench imports this module
    from gcn_maxcut_tpu_torch.bench.locality import locality_params

    if config.number_epochs < 1:
        raise ValueError(f"number_epochs must be >= 1, got {config.number_epochs}")
    mesh = mesh or make_mesh()
    num_shards = mesh.size
    t0 = time.perf_counter()
    with span("sharded.partition"):
        owner = _partition(senders, receivers, n, num_shards, config.partition)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with span("sharded.assemble"):
        sg, g2l = shard_graph(
            senders, receivers, n, num_shards, owner=owner,
            local_reorder=config.local_reorder, block_ell=config.block_ell,
            block_ell_outlier_frac=config.block_ell_outlier_frac,
        )
        sg = sg.to(mesh)
    assembly_s = time.perf_counter() - t0
    n_shard = sg.n_shard

    with span("sharded.setup"):
        if params is None:
            params = locality_params(num_shards * n_shard, config.dim_embedding,
                                     config.hidden_dim, config.num_classes, config.seed)
            params["embed"] = params["embed"].reshape(num_shards, n_shard, -1)
        state = GiantState.create(params, mesh, config.learning_rate)
        step = make_giant_step(sg, mesh, config, state)

    history: List[float] = []
    epoch = 0
    if resume_from is not None:
        conv, opt_state, embed, meta = load_checkpoint(
            resume_from, state.conv, state.opt_state(), state.embed())
        state.load(conv, opt_state, embed)
        epoch = int(meta["epoch"])
        history = list(meta["loss_history"])
        logger.info("resumed %s at epoch %d", resume_from, epoch)

    def _save(tag_epoch: int) -> None:
        save_checkpoint(checkpoint_path, params=state.conv, opt_state=state.opt_state(),
                        embed=state.embed(), epoch=tag_epoch, loss_history=history)
        logger.info("checkpoint @ epoch %d -> %s", tag_epoch, checkpoint_path)

    K = step.runner.max_chunk
    if (config.number_epochs - epoch) % K and epoch < config.number_epochs:
        logger.info("number_epochs=%d rounds up to whole chunks of %d epochs",
                    config.number_epochs, K)
    every = max(K, (checkpoint_every or 0) // K * K)
    t0 = time.perf_counter()
    steady_t0 = None
    last_loss = None
    ran = 0
    while epoch < config.number_epochs:
        losses = step(K)
        if steady_t0 is None:
            steady_t0 = time.perf_counter()    # the first chunk paid the build and capture
        for j, v in enumerate(losses):
            if (epoch + j) % config.log_every == 0:
                history.append(float(v))
                logger.info("giant epoch %d: loss %.1f (cut %.0f)", epoch + j, v, -v)
        last_loss = losses[-1]
        epoch += K
        ran += K
        if (checkpoint_path is not None and checkpoint_every is not None
                and epoch % every == 0 and epoch < config.number_epochs):
            _save(epoch)
    _synchronize(mesh.devices)
    t_end = time.perf_counter()
    final_loss = (float(last_loss) if last_loss is not None
                  else (history[-1] if history else float("nan")))
    if checkpoint_path is not None:
        _save(epoch)
    train_time = time.perf_counter() - t0

    e_directed = int(np.asarray(senders).shape[0])
    if ran > K:
        edges_per_s = e_directed * (ran - K) / (t_end - steady_t0)
    elif ran:
        edges_per_s = e_directed * ran / (t_end - t0)
    else:
        edges_per_s = float("nan")
    timed = {}
    if measure_throughput:
        m = measure_epoch_time(sg, mesh, config, state)
        timed = {
            "edges_per_s_amortized": e_directed / m["epoch_time_s"],
            "epoch_time_s_amortized": m["epoch_time_s"],
            "timing_reliable": m["reliable"],
            "timing_spread_s": m["spread_hi_s"],
            "timing_method": m["method"],
        }
    extra = {}
    if return_assignment:
        with span("sharded.decode"):
            sharded_asn = decode_assignment(sg, mesh, config, state.conv, state.embeds)
            extra["assignment"] = sharded_asn[g2l // n_shard, g2l % n_shard]
    return {
        **timed,
        **extra,
        "final_loss": final_loss,
        "final_cut": -final_loss,
        "total_edges": e_directed // 2,
        "loss_history": history,
        "train_time_s": train_time,
        "epochs": epoch,
        "epochs_run": ran,
        "edges_per_s": edges_per_s,
        "num_shards": num_shards,
        "partition_s": partition_s,
        "assembly_s": assembly_s,
        "n_shard": n_shard,
        "block_ell": sg.bell_block is not None,
    }
