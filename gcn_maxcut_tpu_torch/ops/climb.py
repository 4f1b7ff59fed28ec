"""The greedy-flip climb: its plain PyTorch step and the hand-written CUDA
kernel that climbs each start to its local optimum in one launch.

The climb's primitive is the class-weight matrix ``W[i, c] = Σ_{j∈N(i),
a_j = c} w_ij``, one COO SpMM over the one-hot assignment
(``class_weights``).  Moving node i from class a to class c changes the
cut by ``W[i, a] − W[i, c]`` (``move_gains``).  A step applies, per start,
the first best (row-major over ``[n_pad, k]``) strictly improving move,
gain > 1e-6 (``climb_step``); ``baselines/local_search.py`` runs that step
in lockstep over all starts, eagerly on the CPU and captured on the card.

``greedy_climb`` climbs each start alone to its end, at most ``max_steps``
moves: on a CUDA tensor ``csrc/climb.cu`` (one block a start, the start's
state in shared memory), on a CPU tensor ``greedy_climb_plain``, the same
order in plain PyTorch.  A start with no improving move stays where it
is, so the lockstep loop gives each start exactly min(moves to its local
optimum, ``max_steps``) moves, and both orders give the same assignments.
The kernel takes a graph marked ``symmetric`` (after a move it recomputes
the W rows of the moved node's in-edge senders) whose start fits a block's
shared memory (``kernel_fits``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.segment import spmm

_SMEM_LIMIT = 232_448         # dynamic shared memory one block may use on the H100
CLIMB_THREADS = 512           # csrc/climb.cu CLIMB_THREADS


def class_weights(g: Graph, assignment: torch.Tensor, k: int) -> torch.Tensor:
    """W[..., i, c] = total edge weight from node i into class c, for
    ``assignment`` [n_pad] or [S, n_pad]."""
    onehot = torch.nn.functional.one_hot(assignment.long(), k).float()
    if onehot.dim() == 2:
        return spmm(g, onehot, edge_weights=g.weights * g.edge_mask)
    s = onehot.shape[0]
    x = onehot.permute(1, 0, 2).reshape(g.n_pad, s * k)
    w = spmm(g, x, edge_weights=g.weights * g.edge_mask)
    return w.reshape(g.n_pad, s, k).permute(1, 0, 2)


def move_gains(g: Graph, assignment: torch.Tensor, k: int, num_fixed: int) -> torch.Tensor:
    """gains[..., i, c]: cut delta of moving node i to class c (−inf if
    illegal or staying put)."""
    asn = assignment.long()
    w = class_weights(g, asn, k)
    gains = torch.gather(w, -1, asn[..., None]) - w
    ids = torch.arange(g.n_pad, device=asn.device)
    movable = (ids >= num_fixed) & (g.node_mask > 0)
    gains = torch.where(movable[:, None], gains, -torch.inf)
    stay = torch.nn.functional.one_hot(asn, k).bool()
    return torch.where(stay, -torch.inf, gains)


def climb_step(
    g: Graph, asn: torch.Tensor, rows: torch.Tensor, k: int, num_fixed: int
) -> torch.Tensor:
    """One move a start of ``asn`` [S, n_pad] (int64, in place; ``rows``
    = arange(S)), the first best strictly improving one, gain > 1e-6;
    returns whether no start moved (a bool tensor on the device)."""
    gains = move_gains(g, asn, k, num_fixed).reshape(asn.shape[0], -1)
    flat = torch.argmax(gains, dim=1)
    take = gains[rows, flat] > 1e-6
    i, c = flat // k, flat % k
    asn[rows, i] = torch.where(take, c, asn[rows, i])
    return ~take.any()


def smem_bytes(n_pad: int, k: int) -> int:
    """Shared memory of one block of ``csrc/climb.cu``: W float32 [n_pad,
    k] and asn int32 [n_pad], then the reduction's (gain, index) a warp and
    the step's decision."""
    return n_pad * (k + 1) * 4 + (2 * CLIMB_THREADS // 32 + 1) * 4


def kernel_fits(n_pad: int, k: int, symmetric: bool) -> bool:
    """``csrc/climb.cu`` takes the graph: marked symmetric, and one start's
    state fits a block's shared memory (n_pad up to 14,519 at k = 3)."""
    return symmetric and smem_bytes(n_pad, k) <= _SMEM_LIMIT


def greedy_climb_plain(
    g: Graph, asn: torch.Tensor, k: int, num_fixed: int, max_steps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_climb`` in plain PyTorch: each start of ``asn`` [S, n_pad]
    climbed alone by ``climb_step`` until it makes no move or has made
    ``max_steps``; returns (assignments int64, moves int32 [S])."""
    out = asn.long().clone()
    moves = torch.zeros(out.shape[0], dtype=torch.int32, device=out.device)
    row = torch.zeros(1, dtype=torch.int64, device=out.device)
    for s in range(out.shape[0]):
        n = 0
        while n < max_steps and not bool(climb_step(g, out[s : s + 1], row, k, num_fixed)):
            n += 1
        moves[s] = n
    return out, moves


@functools.cache
def _kernel():
    fn = build.load("climb").climb_launch
    fn.argtypes = [*[ctypes.c_void_p] * 9, *[ctypes.c_int] * 6, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(g: Graph, asn: torch.Tensor, k: int) -> None:
    """The kernel's operand rules; raises on what it does not take."""
    dev = asn.device
    fields = {"senders": torch.int32, "weights": torch.float32, "edge_mask": torch.float32,
              "row_ptr": torch.int32, "node_mask": torch.float32, "n_edges": torch.int32}
    for name, dtype in fields.items():
        t = getattr(g, name)
        if t.device != dev:
            raise ValueError(f"graph field {name} is on {t.device}, the starts on {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"graph field {name} must be contiguous {dtype}, got {t.dtype}")
    n_pad, e_pad = g.n_pad, g.e_pad
    if (g.senders.dim() != 1 or g.weights.shape != (e_pad,) or g.edge_mask.shape != (e_pad,)
            or g.row_ptr.shape != (n_pad + 1,) or g.node_mask.shape != (n_pad,)
            or g.n_edges.numel() != 1):
        raise ValueError("the kernel takes one graph, not a batch")
    if asn.dtype != torch.int64 or asn.dim() != 2 or asn.shape[1] != n_pad or not asn.shape[0]:
        raise ValueError(f"starts must be int64 [S >= 1, {n_pad}], got {asn.dtype} "
                         f"{tuple(asn.shape)}")
    if not asn.is_contiguous():
        raise ValueError("starts must be contiguous")
    if k < 1:
        raise ValueError(f"k = {k} classes")
    if not kernel_fits(n_pad, k, g.symmetric):
        raise ValueError(f"the kernel takes a symmetric graph whose start fits a block "
                         f"({smem_bytes(n_pad, k)} bytes at n_pad = {n_pad}, k = {k}; "
                         f"limit {_SMEM_LIMIT}); symmetric = {g.symmetric}")


def greedy_climb(
    g: Graph, asn: torch.Tensor, k: int = 3, num_fixed: int = 3, max_steps: int = 1000
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each start of ``asn`` [S, n_pad] climbed alone to its local optimum
    or ``max_steps`` moves: (assignments int64 [S, n_pad], moves int32
    [S]).  A CPU tensor runs ``greedy_climb_plain``; a CUDA tensor one
    launch of ``csrc/climb.cu`` on the current stream, with no host read,
    or raises.  Classes must lie in [0, k): the kernel leaves a node of
    another class unmoved where the plain version raises."""
    if asn.device.type != "cuda":
        return greedy_climb_plain(g, asn, k, num_fixed, max_steps)
    _check(g, asn, k)
    s, n_pad = asn.shape
    out = torch.empty_like(asn)
    moves = torch.empty(s, dtype=torch.int32, device=asn.device)
    with torch.cuda.device(asn.device):
        err = _kernel()(
            g.senders.data_ptr(), g.weights.data_ptr(), g.edge_mask.data_ptr(),
            g.row_ptr.data_ptr(), g.node_mask.data_ptr(), g.n_edges.data_ptr(),
            asn.data_ptr(), out.data_ptr(), moves.data_ptr(), s, n_pad, k, num_fixed,
            min(max(0, max_steps), 2**31 - 1), smem_bytes(n_pad, k),
            torch.cuda.current_stream(asn.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"climb_launch failed: CUDA error {err}")
    launches.LAUNCHES["climb"] += 1
    return out, moves
