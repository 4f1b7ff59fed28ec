"""Adam's update: the plain step, leaf by leaf in PyTorch, and the
hand-written CUDA kernel that updates every leaf on a card in one pass.

Both take a ``train.optim.Adam`` (``opt``: its parameters, moments, device
count, rate and bias-correction tables, hyperparameters and ``nonfinite``
flag) and the gradients, update the parameters and moments in place, and add
one to the count.  ``step`` routes by the count's device: on the CPU
``step_plain``; on a card ``step_kernel``, which launches ``csrc/adam.cu``
or raises.

``step_plain`` reads the count, clamps it to ``opt._last`` and reads −lr and
the two bias corrections from ``opt._tables`` (on a card the corrections'
reciprocals, which it multiplies by), then makes some 14 elementwise
passes a leaf.  The kernel does the same arithmetic in the same order, each
operation rounded on its own, so on a card the two give the same bits.

``step_kernel`` launches, on each card that holds leaves, one update of all
its leaves (a further launch per ``MAX_LEAVES`` leaves), then one that adds
one to the count: at most two launches a step on a card.  The launches read
the count on the device, so a step captured in a CUDA graph
(``train/chunks.py``) reads the count of each replay; nothing is read on the
host and nothing allocated on a single card.  The count and the tables live
on the first parameter's card; each other card of a mesh keeps a slot for
the count and a copy of the tables (``side_state``, made once by ``Adam``)
and gets the count copied before its update.

``ops/launches.py`` counts the kernel's launches where they are made:
updates (``adam_update``) and counts (``adam_count``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import launches

MAX_LEAVES = 64               # csrc/adam.cu ADAM_MAX_LEAVES: leaves a launch


def side_state(params: Sequence[torch.Tensor], count: torch.Tensor,
               tables: torch.Tensor) -> Dict[torch.device, tuple]:
    """For each card other than the count's that holds parameters (a mesh):
    the slot its launch reads the count from and a copy of the tables."""
    return {d: (torch.zeros_like(count, device=d), tables.to(d))
            for d in dict.fromkeys(p.device for p in params)
            if d != count.device and d.type == "cuda"}


@torch.no_grad()
def step_plain(opt, grads: Sequence[torch.Tensor]) -> None:
    """One Adam step in plain PyTorch, leaf by leaf, on any device."""
    at = torch.clamp(opt._count, max=opt._last)
    home = opt._count.device
    scalars = {home: opt._tables.index_select(1, at).view(3)}
    opt._count.add_(1)
    for i, (p, g) in enumerate(zip(opt.params, grads)):
        if p.device not in scalars:     # a mesh over several cards
            scalars[p.device] = scalars[home].to(p.device)
        neg_lr, bc1, bc2 = scalars[p.device]
        if opt.nonfinite is not None:
            opt.nonfinite.logical_or_((~torch.isfinite(g).all()).to(home))
        # (1 − b1)·g + b1·mu and (1 − b2)·g² + b2·nu, in place where the
        # stored moment is float32 (a sum of two rounded products either way)
        mu = g * (1.0 - opt.b1)
        if opt.mu[i].dtype == mu.dtype:
            mu = opt.mu[i].mul_(opt.b1).add_(mu)
        else:
            mu = mu + opt.b1 * opt.mu[i]
            opt.mu[i].copy_(mu)
        nu = opt.nu[i].mul_(opt.b2).add_((g * g) * (1.0 - opt.b2))
        if opt._reciprocal:
            update = (mu * bc1) / (torch.sqrt(nu * bc2) + opt.eps)
        else:
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
        p.add_(update * neg_lr)


@functools.cache
def _kernel():
    fn = build.load("adam").adam_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *[ctypes.c_float] * 5,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(leaves: List[tuple], device: torch.device) -> None:
    """The kernel's operand rules for one card's leaves; raises on what it
    does not take."""
    mu_dtypes = {mu.dtype for _, _, mu, _ in leaves}
    if len(mu_dtypes) > 1:
        raise ValueError(f"first moments of several dtypes on {device}: {mu_dtypes}")
    for i, (p, g, mu, nu) in enumerate(leaves):
        for name, t, dtypes in (("parameter", p, (torch.float32,)),
                                ("gradient", g, (torch.float32,)),
                                ("first moment", mu, (torch.float32, torch.bfloat16)),
                                ("second moment", nu, (torch.float32,))):
            if t.device != device:
                raise ValueError(f"leaf {i}: {name} on {t.device}, its parameter on {device}")
            if t.dtype not in dtypes or not t.is_contiguous():
                raise ValueError(f"leaf {i}: {name} must be contiguous "
                                 f"{' or '.join(map(str, dtypes))}, got {t.dtype}"
                                 f"{'' if t.is_contiguous() else ', not contiguous'}")
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} of shape {tuple(t.shape)}, "
                                 f"its parameter {tuple(p.shape)}")


def _launch(opt, leaves: List[tuple], device: torch.device, count: torch.Tensor,
            tables: torch.Tensor, nonfinite: torch.Tensor | None, increment: bool) -> None:
    _check(leaves, device)
    ptrs = (ctypes.c_uint64 * (4 * len(leaves)))(
        *(t.data_ptr() for leaf in leaves for t in leaf))
    numel = (ctypes.c_longlong * max(1, len(leaves)))(*(p.numel() for p, *_ in leaves))
    with torch.cuda.device(device):
        err = _kernel()(
            ctypes.addressof(ptrs), ctypes.addressof(numel), len(leaves),
            int(bool(leaves) and leaves[0][2].dtype == torch.bfloat16),
            count.data_ptr(), tables.data_ptr(), opt._last,
            np.float32(opt.b1), np.float32(1.0 - opt.b1), np.float32(opt.b2),
            np.float32(1.0 - opt.b2), np.float32(opt.eps),
            None if nonfinite is None else nonfinite.data_ptr(),
            int(increment), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adam_launch failed: CUDA error {err}")
    groups = range(0, len(leaves), MAX_LEAVES)
    launches.LAUNCHES["adam_update"] += sum(
        any(p.numel() for p, *_ in leaves[i:i + MAX_LEAVES]) for i in groups)
    launches.LAUNCHES["adam_count"] += int(increment)


@torch.no_grad()
def step_kernel(opt, grads: Sequence[torch.Tensor]) -> None:
    """One Adam step on the card: ``csrc/adam.cu`` once a card (see the
    module docstring); raises on leaves it does not take."""
    home = opt._count.device
    if home.type != "cuda" or not opt._reciprocal:
        raise ValueError(f"the kernel steps an optimizer made on a card, not on {home}")
    if len(grads) != len(opt.params):
        raise ValueError(f"{len(grads)} gradients for {len(opt.params)} leaves")
    cards: Dict[torch.device, List[tuple]] = {home: []}
    for p, g, mu, nu in zip(opt.params, grads, opt.mu, opt.nu):
        if p.device.type != "cuda":
            raise ValueError(f"a leaf on {p.device} among the card's leaves")
        cards.setdefault(p.device, []).append((p, g, mu, nu))
    for dev, leaves in cards.items():
        if dev == home:
            continue
        count, tables = opt._side[dev]
        count.copy_(opt._count)
        flag = None if opt.nonfinite is None else torch.zeros(1, dtype=torch.bool, device=dev)
        _launch(opt, leaves, dev, count, tables, flag, increment=False)
        if flag is not None:
            opt.nonfinite.logical_or_(flag.to(home))
    _launch(opt, cards[home], home, opt._count, opt._tables, opt.nonfinite, increment=True)


def step(opt, grads: Sequence[torch.Tensor]) -> None:
    """One Adam step: the kernel on a card, the plain step on the CPU."""
    if opt._count.device.type == "cuda":
        step_kernel(opt, grads)
    else:
        step_plain(opt, grads)
