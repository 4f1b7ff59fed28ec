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
drawn from ``seed`` with a ``torch.Generator``.  The packed trainer writes
and resumes checkpoints in the JAX package's layout (``train/checkpoint.py``;
the Adam state as optax's ``{"0": {".count", ".mu", ".nu"}}``), so a run of
either package resumes in the other.

Epochs run in chunks of ``epochs_per_call`` (10, the JAX default;
``train/chunks.py``: one captured CUDA graph replayed on the card), with
the JAX trainers' epoch count: whole chunks, and at least two in a fresh
run.  Epoch time is the mean over the chunks after the first (which
includes the kernel build and the capture), from CUDA events on the card
and the host clock on the CPU; checkpoint writes fall outside the timed
stretches and are timed on their own.  Under a profiler session both
trainers record everything before their first chunk as the span
``giant.setup`` (``utils/profiling.py``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.models.gcn import gcn_conv_init
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm_unit, banded_spmm_unit_packed
from gcn_maxcut_tpu_torch.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gcn_maxcut_tpu_torch.train.chunks import chunk_sizes, chunk_step
from gcn_maxcut_tpu_torch.train.optim import Adam
from gcn_maxcut_tpu_torch.utils.profiling import span

G = 16  # lane-group width of the packed layout (classes padded to it)


def circulant_offsets(d: int, bandwidth: int, seed: int) -> tuple[int, ...]:
    """The d shifts ``(s1, -s1, s2, -s2, ...)``, drawn as the JAX package
    draws them."""
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    return tuple(int(o) for s in half for o in (s, -s))


def banded_gcn_conv(
    params: Dict[str, torch.Tensor], x: torch.Tensor, offsets: Sequence[int],
    degree: int, block: int | None = None,
) -> torch.Tensor:
    """GraphConv (norm='both') on an exactly regular circulant graph:
    ``(A · (x / √degree)) · W / √degree + b`` with A the circulant operator
    of ``offsets`` (``ops/banded.banded_spmm_unit``, K2 on the card).

    The projection runs first when it narrows the rows (out < in), so the
    aggregation runs at the smaller width: DGL's rule, by FLOPs.  The JAX
    package first prefers the 128-lane-aligned side (its Pallas kernel
    takes only those widths), which is TPU mechanism: at 16 → 128 it
    projects first, at 128 → 16 it aggregates first, the other way round
    from this function.  The two orders are the same product, equal up to
    float order.  ``block`` is the JAX kernel's row block, which the CUDA
    kernel does not take; it is accepted and ignored."""
    norm = 1.0 / math.sqrt(float(degree))
    h = x * norm
    if params["w"].shape[1] < params["w"].shape[0]:
        h = banded_spmm_unit(h @ params["w"], offsets)
    else:
        h = banded_spmm_unit(h, offsets) @ params["w"]
    return h * norm + params["b"]


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


def group_softmax(h: torch.Tensor, class_ok: torch.Tensor) -> torch.Tensor:
    """Softmax over the real classes (``class_ok`` lanes) of each 16-lane
    row; the max is a shift and carries no gradient."""
    gmax = (h + (class_ok - 1.0) * 1e9).amax(dim=-1, keepdim=True).detach()
    e = torch.exp(h - gmax) * class_ok
    return e / e.sum(dim=-1, keepdim=True)


def pin_group_head(probs: torch.Tensor, term_onehot: torch.Tensor) -> torch.Tensor:
    """Rows 0..k-1 (the terminals) pinned to ``term_onehot``, identity
    gradient."""
    head = probs[: term_onehot.shape[0]]
    return torch.cat([(term_onehot - head).detach() + head, probs[term_onehot.shape[0]:]])


def group_onehot(pinned: torch.Tensor, class_ok: torch.Tensor) -> torch.Tensor:
    """Straight-through group argmax: every lane equal to the row's max is
    set (ties set several lanes, as in the JAX trainer)."""
    gmax = pinned.amax(dim=-1, keepdim=True)
    hard = ((pinned >= gmax).to(pinned.dtype) * class_ok).detach()
    return (hard - pinned).detach() + pinned


def group_argmax(pinned: torch.Tensor, class_ok: torch.Tensor) -> torch.Tensor:
    """The decoded class of each row, over the real classes."""
    return torch.argmax(torch.where(class_ok > 0, pinned.float(), -torch.inf), dim=-1)


def _leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [params["conv1"]["w"], params["conv1"]["b"],
            params["conv2"]["w"], params["conv2"]["b"], params["embed"]]


def _synchronize(devices: Sequence[torch.device]) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _seconds(fn: Callable[[], None], devices: Sequence[torch.device]) -> float:
    """Seconds ``fn``'s work takes: CUDA events on ``devices[0]``'s stream
    after every device is synchronised, or the host clock on the CPU."""
    dev = devices[0]
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(dev))
    fn()
    _synchronize(devices)
    end.record(torch.cuda.current_stream(dev))
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _train(
    chunk: Callable[[int], np.ndarray],
    devices: Sequence[torch.device],
    chunks: Sequence[int],
    on_chunk: Callable[[int, List[float]], None] | None = None,
) -> tuple[List[float], float, float]:
    """Runs ``chunk`` (``chunk_step``) on ``chunks[i]`` epochs in turn;
    returns (loss history, the first chunk's seconds, the mean seconds an
    epoch of the later chunks, or of the first when it is the only one).
    The first chunk pays the kernels' build and the capture, on the host
    clock; the later ones are timed with CUDA events on the card.  Every
    device is synchronised before a time is read.  After each chunk but
    the last, ``on_chunk(epochs done in this call, history so far)`` runs
    outside the timed stretches."""
    history: List[float] = []

    def run(k: int) -> None:
        history.extend(float(v) for v in chunk(k))

    t0 = time.perf_counter()
    run(chunks[0])
    _synchronize(devices)
    first = time.perf_counter() - t0
    done, timed = chunks[0], 0.0
    for k in chunks[1:]:
        if on_chunk is not None:
            on_chunk(done, history)
        timed += _seconds(lambda: run(k), devices)
        done += k
    steady = timed / (done - chunks[0]) if len(chunks) > 1 else first / chunks[0]
    return history, first, steady


def _tree(leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The five leaves of ``_leaves`` as the JAX parameter tree."""
    w1, b1, w2, b2, embed = leaves
    return {"conv1": {"w": w1, "b": b1}, "conv2": {"w": w2, "b": b2}, "embed": embed}


def _adam_state(optimizer: Adam) -> Dict[str, Any]:
    """The Adam state in optax's layout for ``optax.adam`` over the tree."""
    return {"0": {".count": torch.tensor(optimizer.count, dtype=torch.int32),
                  ".mu": _tree(optimizer.mu), ".nu": _tree(optimizer.nu)}}


@torch.no_grad()
def _resume(path: str, params: Dict[str, Any], optimizer: Adam) -> tuple[int, List[float]]:
    """Load a checkpoint into ``params`` and ``optimizer`` (each leaf in
    its own dtype: a bfloat16 first moment comes back as bfloat16); returns
    (epochs done, loss history)."""
    loaded, opt, _, meta = load_checkpoint(path, params, _adam_state(optimizer))
    for t, v in zip(_leaves(params), _leaves(loaded)):
        t.copy_(v)
    state = opt["0"]
    optimizer.load(int(state[".count"]), _leaves(state[".mu"]), _leaves(state[".nu"]))
    return int(meta["epoch"]), list(meta["loss_history"])


def _result(n, d, epochs, history, first, steady, layout, offsets):
    e_undirected = n * d // 2
    final_cut = -history[-1]
    return {
        "n": n,
        "d": d,
        "edges": e_undirected,
        "epochs": epochs,
        "first_chunk_s": first,
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
    epochs_per_call: int = 10,
    bandwidth: int = 63,
    seed: int = 0,
    params: Dict[str, Any] | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Two-layer banded GCN in node order (the kernel at r = 1); returns the
    cut and the epoch throughput.  ``params``: ``{"conv1": {"w": [emb,
    hidden], "b"}, "conv2": {"w": [hidden, classes], "b"}, "embed": [n,
    emb]}``.  Epochs run in chunks of ``epochs_per_call`` as in the JAX
    trainer: ``epochs`` rounds up to whole chunks, and at least two run,
    the second the first timed one.

    Under a profiler session everything before the first chunk (the
    device, the offsets, the parameters' copy to the device, the closures,
    Adam's state, the chunk callable) is the span ``giant.setup``, as in
    ``train_banded_giant_packed``."""
    with span("giant.setup"):
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

        def loss_fn(p):
            h = torch.relu(banded_gcn_conv(p["conv1"], p["embed"], offsets, d))
            probs = torch.softmax(banded_gcn_conv(p["conv2"], h, offsets, d), dim=-1)
            onehot = ste_argmax_onehot(pin_terminals(probs))
            same = torch.dot(onehot.reshape(-1), banded_spmm_unit(onehot, offsets).reshape(-1))
            return -(e_undirected - 0.5 * same)

        optimizer = Adam(_leaves(params), learning_rate)
        chunks = chunk_sizes(0, epochs, epochs_per_call, first_two=True)
        chunk = chunk_step(lambda: loss_fn(params), _leaves(params), optimizer, [dev],
                           max(chunks))
    history, first, steady = _train(chunk, [dev], chunks)
    return _result(n, d, sum(chunks), history, first, steady, "plain", offsets)


def train_banded_giant_packed(
    n: int = 10_002_432,
    d: int = 8,
    dim_embedding: int = 32,
    hidden_dim: int = 16,
    num_classes: int = 3,
    learning_rate: float = 1e-3,
    epochs: int = 50,
    epochs_per_call: int = 10,
    bandwidth: int = 63,
    r: int = 8,
    seed: int = 0,
    agg_dtype: str | None = "bfloat16",
    act_dtype: str | None = None,
    mu_dtype: str | None = "bfloat16",
    return_assignment: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int | None = None,
    resume_from: str | None = None,
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

    Epochs run in chunks of ``epochs_per_call`` as in the JAX trainer:
    ``epochs`` rounds up to whole chunks, and a fresh run runs at least
    two, the second the first timed one.

    ``checkpoint_path``: write the parameters, the Adam state (the first
    moment in ``mu_dtype``, stored as float32) and the loss history there
    after every chunk whose epoch count is a multiple of
    ``checkpoint_every`` rounded down to whole chunks (at least one),
    short of ``epochs``, and at the end, each time over the same file;
    ``meta["epoch"]`` is the count of epochs done.  ``checkpoint_writes``
    lists each write's epoch, seconds and bytes.  ``resume_from``:
    continue from such a checkpoint (of either package; ``resume_s`` is
    the load's seconds) in whole chunks to ``epochs``; raises when the
    checkpoint is already at or past ``epochs``.  The history then starts
    with the checkpoint's, and the epoch time is that of the epochs this
    call ran: the first chunk's own when it ran only one (the JAX trainer
    then reports a near-zero time).

    Under a profiler session everything before the first chunk (the
    parameters' copy to the device, the closures, Adam's state, the chunk
    callable) is the span ``giant.setup`` (``utils/profiling.py``).
    """
    if hidden_dim != G or dim_embedding % G:
        raise ValueError("packed trainer expects hidden_dim=16, emb % 16 == 0")
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    with span("giant.setup"):
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
            return pin_group_head(group_softmax(h, class_ok), term_onehot)

        def loss_fn(p):
            onehot = group_onehot(pinned_probs(p), class_ok)
            same = torch.dot(
                onehot.to(torch.float32).reshape(-1),
                spmm(onehot).to(torch.float32).reshape(-1),
            )
            return -(e_undirected - 0.5 * same)

        optimizer = Adam(
            _leaves(params), learning_rate,
            mu_dtype=None if mu_dtype is None else getattr(torch, mu_dtype),
        )
        history: List[float] = []
        start, resume_s = 0, None
        if resume_from is not None:
            t0 = time.perf_counter()
            start, history = _resume(resume_from, params, optimizer)
            resume_s = time.perf_counter() - t0
            if start >= epochs:
                raise ValueError(f"checkpoint already at epoch {start} >= epochs={epochs}")
        writes: List[Dict[str, Any]] = []

        def save(done: int, hist: List[float]) -> None:
            t0 = time.perf_counter()
            path = save_checkpoint(checkpoint_path, params=params,
                                   opt_state=_adam_state(optimizer), epoch=done,
                                   loss_history=hist)
            writes.append({"epoch": done, "seconds": time.perf_counter() - t0,
                           "bytes": path.stat().st_size})

        chunks = chunk_sizes(start, epochs, epochs_per_call, first_two=start == 0)
        every = max(chunks[0], checkpoint_every // chunks[0] * chunks[0]) if checkpoint_every else 0

        def on_chunk(done: int, hist: List[float]) -> None:
            if checkpoint_path is not None and every and (start + done) % every == 0 \
                    and start + done < epochs:
                save(start + done, history + hist)

        chunk = chunk_step(lambda: loss_fn(params), _leaves(params), optimizer, [dev], max(chunks))
    new, first, steady = _train(chunk, [dev], chunks, on_chunk)
    history += new
    epochs = start + sum(chunks)
    if checkpoint_path is not None:
        save(epochs, history)
    res = _result(n, d, epochs, history, first, steady, "packed", offsets)
    res.update(resumed_from_epoch=start, resume_s=resume_s, checkpoint_writes=writes)
    if return_assignment:
        with torch.no_grad():
            cls = group_argmax(pinned_probs(params), class_ok)   # position order
            res["assignment"] = (
                cls.view(m, r).T.reshape(n).to(torch.int32).cpu().numpy()
            )
    return res
