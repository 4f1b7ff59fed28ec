"""The packed giant trainer's head and cut loss: the plain composition and
the hand-written CUDA op.

The packed trainer (``bench/giant_demo.train_banded_giant_packed``) ends
each forward in the same way: from K3's output z [n, 16] of the second
layer, h = z·(1/d) + b2, the softmax over the real classes of each 16-lane
row (``group_softmax``), the terminal rows 0..k-1 pinned to their own
class (``pin_group_head``), the straight-through one-hot S of the row's
largest lanes (``group_onehot``), and the loss's ⟨S, A S⟩ with A S = K3(S).

``group_head_cut(z, b2, inv_d, num_classes, offsets, r)`` returns that
⟨S, A S⟩ as a 0-d float32, differentiable in z and b2, on a card only.
``group_head_cut_plain`` is its plain version, the composition of those
three functions and a ``torch.dot``.  The op is ``csrc/group_head.cu``:
one launch from z to S (``group_head``), K3 on S, one launch for the dot
(``cut_dot``); and backward K3's adjoint on S, then one launch from z,
A S and Aᵀ S to z's cotangent and b2's gradient (``group_head_backward``).  S is exactly 0 or
1 in z's dtype, the composition's one-hot bit for bit; the dot sums exact
integer products, so it differs from the composition's float32 dot by that
dot's own rounding; the gradients are the composition's up to rounding.
Each launch allocates through PyTorch's caching allocator and reads the
loss's cotangent on the device, so the op captures into a CUDA graph
(``train/chunks.py``); ``ops/launches.py`` counts the three launches.

``takes`` is the trainer's one route rule: the op runs on a card for
float32 activations and at most 16 classes; any other run keeps the
composition, which the trainer writes out itself so that its
``group_onehot`` stays a module global there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm_unit_packed

G = 16  # lanes of a row: the packed layout's group width
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def takes(device: torch.device | str, act_dtype: torch.dtype, num_classes: int) -> bool:
    """Whether the packed trainer runs its head as the CUDA op: on a card,
    with float32 activations and 1..16 classes."""
    return (torch.device(device).type == "cuda" and act_dtype == torch.float32
            and 1 <= num_classes <= G)


def _masks(num_classes: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(class_ok [16], term_onehot [k, 16]) in float32, as the trainer makes them."""
    class_ok = (torch.arange(G, device=device) < num_classes).to(torch.float32)
    return class_ok, torch.eye(G, device=device, dtype=torch.float32)[:num_classes]


def group_head_cut_plain(z: torch.Tensor, b2: torch.Tensor, inv_d: float, num_classes: int,
                         offsets: Sequence[int], r: int) -> torch.Tensor:
    """⟨S, A S⟩ in plain PyTorch, as the trainer composes it: z [n, 16] (the
    streams' dtype), b2 [16] float32, activations in float32, K3 on S in
    z's dtype."""
    class_ok, term_onehot = _masks(num_classes, z.device)
    h = z.to(torch.float32) * inv_d + b2
    onehot = group_onehot(pin_group_head(group_softmax(h, class_ok), term_onehot), class_ok)
    y = banded_spmm_unit_packed(onehot.to(z.dtype), offsets, r).to(torch.float32)
    return torch.dot(onehot.reshape(-1), y.reshape(-1))


def gradient_excess(dz: torch.Tensor, db2: torch.Tensor, want_dz: torch.Tensor,
                    want_db2: torch.Tensor, inv_d: float) -> tuple[float, float]:
    """How far the op's gradients (dz, db2) lie from the plain op's, each as
    its largest share of the tolerance the card's checks hold it to (at most
    1 passes).  z's cotangent: one ulp of its dtype relative (2^-7 bfloat16,
    1e-5 float32) plus 1e-6, as the softmax adjoint is taken in another
    order than autograd's.  b2's gradient, a float32 sum over the rows in
    another order: 1e-5 relative plus one float32 ulp (2^-23) of Σ|g_h|
    over the rows, g_h = want_dz / inv_d; the rows' terms cancel to a sum
    far below their magnitudes.  A lane whose tolerance is 0 (b2's padding
    lanes) must match exactly."""
    def excess(diff, bound):
        return float(torch.where(diff == 0, 0.0, diff / bound).max())

    want = want_dz.float()
    ulp = 2.0 ** -7 if want_dz.dtype == torch.bfloat16 else 1e-5
    magnitude = want.abs().sum(0) / inv_d
    return (excess((dz.float() - want).abs(), 1e-6 + ulp * want.abs()),
            excess((db2 - want_db2).abs(), 1e-5 * want_db2.abs() + 2.0 ** -23 * magnitude))


@functools.cache
def _kernels():
    lib = build.load("group_head")
    forward, dot, backward = (lib.group_head_launch, lib.cut_dot_launch,
                              lib.group_head_backward_launch)
    forward.argtypes = [*[ctypes.c_void_p] * 3, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                        ctypes.c_int, ctypes.c_void_p]
    dot.argtypes = [*[ctypes.c_void_p] * 2, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                    *[ctypes.c_void_p] * 2, ctypes.c_int, ctypes.c_void_p]
    backward.argtypes = [*[ctypes.c_void_p] * 7, ctypes.c_int, *[ctypes.c_void_p] * 2,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p]
    forward.restype = dot.restype = backward.restype = ctypes.c_int
    return forward, dot, backward


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grid(n: int, device: torch.device) -> int:
    """Blocks of 256 threads for the dot and the backward over n rows: one
    a 256 rows, at most 8 an SM (one wave at full occupancy).  The launch
    takes this grid and the partial sums have one row a block."""
    return max(1, min(-(-n // 256), 8 * _sms(device)))


def _check(z: torch.Tensor, b2: torch.Tensor, num_classes: int) -> None:
    """The kernels' operand rules; raises on what they do not take."""
    if z.device.type != "cuda" or b2.device != z.device:
        raise ValueError(f"the head's kernels take z and b2 on one card, got {z.device} "
                         f"and {b2.device}")
    if z.dtype not in _DTYPE_CODES:
        raise ValueError(f"the head's kernels take float32 or bfloat16 z, got {z.dtype}")
    if z.dim() != 2 or z.shape[1] != G or not z.shape[0] or not z.is_contiguous() \
            or z.data_ptr() % 16:
        raise ValueError(f"z must be contiguous [n, {G}], 16-byte aligned, got "
                         f"{tuple(z.shape)}")
    if b2.dtype != torch.float32 or b2.shape != (G,) or not b2.is_contiguous():
        raise ValueError(f"b2 must be contiguous float32 [{G}], got {b2.dtype} "
                         f"{tuple(b2.shape)}")
    if not 1 <= num_classes <= G:
        raise ValueError(f"the head's kernels take 1..{G} classes, got {num_classes}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def group_head_onehot(z: torch.Tensor, b2: torch.Tensor, inv_d: float,
                      num_classes: int) -> torch.Tensor:
    """S [n, 16] in z's dtype from ``csrc/group_head.cu``'s forward launch
    (a card only; no gradient)."""
    _check(z, b2, num_classes)
    s = torch.empty_like(z)
    with torch.cuda.device(z.device):
        err = _kernels()[0](z.data_ptr(), b2.data_ptr(), s.data_ptr(), z.shape[0], num_classes,
                            np.float32(inv_d), _DTYPE_CODES[z.dtype], _stream(z.device))
    if err != 0:
        raise RuntimeError(f"group_head_launch failed: CUDA error {err}")
    launches.LAUNCHES["group_head"] += 1
    return s


def _cut_dot(s: torch.Tensor, y: torch.Tensor, ticket: torch.Tensor) -> torch.Tensor:
    dev = s.device
    out = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(_grid(s.shape[0], dev), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _kernels()[1](s.data_ptr(), y.data_ptr(), s.shape[0], partials.data_ptr(),
                            partials.shape[0], ticket.data_ptr(), out.data_ptr(),
                            _DTYPE_CODES[s.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(f"cut_dot_launch failed: CUDA error {err}")
    launches.LAUNCHES["cut_dot"] += 1
    return out


class _GroupHeadCut(torch.autograd.Function):
    """``csrc/group_head.cu`` and K3 as one autograd op (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, z, b2, inv_d, num_classes, offsets, r):
        s = group_head_onehot(z, b2, inv_d, num_classes)
        y = banded_spmm_unit_packed(s, offsets, r)
        # the dot's and the backward's tickets: the count of their blocks done
        tickets = torch.zeros(2, dtype=torch.int32, device=z.device)
        ctx.save_for_backward(z, b2, s, y, tickets)
        ctx.inv_d, ctx.num_classes, ctx.offsets, ctx.r = inv_d, num_classes, offsets, r
        return _cut_dot(s, y, tickets[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, b2, s, y, tickets = ctx.saved_tensors
        # K3's adjoint on S: the cotangent of A S is g·S, and Aᵀ(g·S) = g·(Aᵀ S)
        at = banded_spmm_unit_packed(s, tuple(-o for o in ctx.offsets), ctx.r)
        g = g.to(torch.float32).contiguous()
        dev = z.device
        dz = torch.empty_like(z)
        db2 = torch.empty(G, dtype=torch.float32, device=dev)
        partials = torch.empty(_grid(z.shape[0], dev), G, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _kernels()[2](
                z.data_ptr(), b2.data_ptr(), y.data_ptr(), at.data_ptr(), g.data_ptr(),
                dz.data_ptr(), partials.data_ptr(), partials.shape[0],
                tickets[1].data_ptr(), db2.data_ptr(), z.shape[0], ctx.num_classes,
                np.float32(ctx.inv_d), _DTYPE_CODES[z.dtype], _stream(dev))
        if err != 0:
            raise RuntimeError(f"group_head_backward_launch failed: CUDA error {err}")
        launches.LAUNCHES["group_head_backward"] += 1
        return dz, db2, None, None, None, None


def group_head_cut(z: torch.Tensor, b2: torch.Tensor, inv_d: float, num_classes: int,
                   offsets: Sequence[int], r: int) -> torch.Tensor:
    """⟨S, A S⟩ (0-d float32) of the packed head on z [n, 16] and b2 [16]
    on a card, by the kernels (z made contiguous; float32 or bfloat16 on
    one card, else it raises).  ``group_head_cut_plain`` is its plain
    version; the trainer chooses between them by ``takes``."""
    return _GroupHeadCut.apply(z.contiguous(), b2.contiguous(), float(inv_d), int(num_classes),
                               tuple(int(o) for o in offsets), int(r))
