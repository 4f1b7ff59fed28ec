"""Chunks of epochs in one device call: the port of the JAX package's
``jit(lax.scan)`` over ``epochs_per_call`` epochs, and of its
``while_loop``s over the steps of a search.

A trainer hands ``ChunkRunner`` a one-epoch step: a closure over tensors
that keep their storage for the whole run (parameters and optimizer state,
updated in place, graph tables), returning the epoch's loss as a 0-d
tensor, or ``(loss, stop)`` with the 0-d flag of a loop that stops early;
a step with no loss (a search step) returns None in its place.
``run(k)`` runs k epochs and returns their losses and stop flags, read
from the device once; ``run_many(n)`` runs n in chunks.  ``chunk_step``
is the chunk callable of a trainer whose epoch is one Adam step on a
loss's gradient.

On a CUDA device the first epoch of the run is eager, on a side stream: it
is the warm-up (kernels build, libraries load) and a real epoch of the
run.  One epoch is then captured into a ``torch.cuda.CUDAGraph`` on that
stream, and every later epoch is a replay of it: the host launches one
graph an epoch and reads nothing until the chunk ends.  Each epoch writes
its loss and stop flag into device buffers at a device index, which the
graph advances.  A step that cannot be captured (a host read such as
``.item()`` or ``float()``, a shape that depends on the data) makes the
capture raise; the card never runs such a step eagerly instead.  A mesh
whose devices span several cards runs its chunks without capture (logged
once): capture across cards waits for a machine with more cards.  On the
CPU every epoch is eager: the same code, with the same single read a chunk.

The kernel launch counters (``LAUNCHES`` of ``ops/block_ell.py``,
``ops/banded.py``, ``ops/halo.py`` and ``ops/probe_kernels.py``) count the
wrappers' Python calls, and a replay makes none.  So the runner takes back
what the counters gained while capturing (a capture launches nothing) and
adds that gain once for every replay.

A step that draws from its own ``torch.Generator`` (the recipe's dropout)
names it in ``generators``: the graph registers its state before capture,
so every replay advances the generator as an eager epoch would and draws
the same numbers.

``checked(run)`` (``utils/debug.py``) turns on a device flag that records
any non-finite loss or gradient of the chunk (the gradients as the step's
``Adam`` sees them) and raises after the chunk.
"""

from __future__ import annotations

import importlib
import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_COUNTER_MODULES = ("block_ell", "banded", "halo", "probe_kernels")
_LOGGED: set = set()


def _counters() -> List[dict]:
    return [importlib.import_module(f"gcn_maxcut_tpu_torch.ops.{m}").LAUNCHES
            for m in _COUNTER_MODULES]


def chunk_sizes(start: int, epochs: int, per_call: int, first_two: bool = False) -> List[int]:
    """The JAX trainers' chunks from epoch ``start``: whole chunks of
    ``per_call`` epochs until ``epochs`` is reached, so the run rounds up to
    a multiple of ``per_call``; ``first_two`` (the single-chip giant
    trainers' fresh runs) always runs a second chunk, the first steady one."""
    k = max(1, int(per_call))
    n = max(1, -(-(epochs - start) // k))
    return [k] * (max(n, 2) if first_two else n)


class ChunkRunner:
    """Runs a one-epoch step in chunks; see the module docstring.

    ``devices``: the devices the step touches (the first holds the loss);
    ``max_chunk``: the longest chunk ``run`` takes; ``capture``: None
    captures on a single CUDA device and runs eagerly elsewhere, False
    runs eagerly (the comparison with an eager epoch on the card);
    ``generators``: the generators the step draws from."""

    def __init__(
        self,
        step: Callable[[], torch.Tensor | Tuple[torch.Tensor, torch.Tensor]],
        devices: Sequence[torch.device | str],
        max_chunk: int,
        capture: bool | None = None,
        optimizer=None,
        generators: Sequence[torch.Generator] = (),
    ):
        devs = list(dict.fromkeys(torch.device(d) for d in devices))
        self.device = devs[0]
        cards = self.device.type == "cuda"
        if cards and len(devs) > 1 and capture is None and "spans" not in _LOGGED:
            _LOGGED.add("spans")
            logger.info("a mesh over %d cards runs its chunks without capture", len(devs))
        if capture is None:
            capture = cards and len(devs) == 1
        if capture and not (cards and len(devs) == 1):
            raise ValueError(f"capture needs one CUDA device, got {devs}")
        self.step, self.max_chunk, self.capture = step, int(max_chunk), capture
        self.optimizer = optimizer
        self.generators = list(generators)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captured_launches: List[dict] = []
        self.eager_epochs = self.replays = 0
        self.nonfinite_seen = False
        k = self.max_chunk
        self._losses = torch.zeros(k, dtype=torch.float32, device=self.device)
        self._stops = torch.zeros(k, dtype=torch.float32, device=self.device)
        self._bad = torch.zeros(1, dtype=torch.bool, device=self.device)
        self._pos = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._check = False

    def enable_check(self) -> None:
        """Record non-finite losses and gradients from now on (before the
        first chunk: a captured epoch keeps what it was captured with)."""
        if self.graph is not None or self.eager_epochs:
            raise RuntimeError("checked() must wrap a runner before its first chunk")
        self._check = True
        if self.optimizer is not None:
            self.optimizer.nonfinite = self._bad

    def _epoch(self) -> Tuple[torch.Tensor | None, torch.Tensor | None]:
        """One step; its loss as float32 [1] and its stop flag (None where
        the step has none)."""
        out = self.step()
        loss, stop = out if isinstance(out, tuple) else (out, None)
        if loss is not None:
            loss = loss.detach().reshape(1).to(torch.float32)
            if self._check:
                self._bad.logical_or_(~torch.isfinite(loss))
        return loss, stop

    def _recorded_epoch(self) -> None:
        """One step writing its loss and stop flag at the device index (the
        captured form: a replay cannot hand its outputs to the host)."""
        loss, stop = self._epoch()
        if loss is not None:
            self._losses.index_copy_(0, self._pos, loss)
        if stop is not None:
            self._stops.index_copy_(0, self._pos, stop.reshape(1).to(torch.float32))
        self._pos.add_(1)

    def _capture(self) -> None:
        """The warm-up epoch, then one epoch captured on the same side stream."""
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self._recorded_epoch()
        here.wait_stream(side)
        self.eager_epochs += 1
        counters = _counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph, stream=side):
                self._recorded_epoch()
        except Exception as e:
            raise RuntimeError(
                "capturing the epoch into a CUDA graph failed; a chunk's step must not "
                "read the device on the host or take shapes from its data") from e
        finally:
            self.captured_launches = [{k: c[k] - b.get(k, 0) for k in c}
                                      for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)
        self.graph = graph

    def run(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k epochs; returns their losses and stop flags (float32, bool;
        zeros and False where the step has none)."""
        if not 1 <= k <= self.max_chunk:
            raise ValueError(f"chunk of {k} epochs, runner takes 1..{self.max_chunk}")
        if self._check:
            self._bad.zero_()
        if not self.capture:
            # eager: copies of the outputs (a step may return a buffer it
            # updates later) stay in a list, joined once for the read
            outs = [[None if t is None else t.reshape(1).to(torch.float32, copy=True)
                     for t in self._epoch()] for _ in range(k)]
            losses, stops = (torch.cat(col) if col[0] is not None
                             else torch.zeros(k, device=self.device) for col in zip(*outs))
            self.eager_epochs += k
        else:
            self._pos.zero_()
            replays = k
            if self.graph is None:
                self._capture()
                replays -= 1
            for _ in range(replays):
                self.graph.replay()
            self.replays += replays
            for c, gain in zip(_counters(), self.captured_launches):
                for name, v in gain.items():
                    c[name] += v * replays
            losses, stops = self._losses[:k], self._stops[:k]
        out = torch.cat([losses, stops, self._bad.float()]).cpu().numpy()
        self.nonfinite_seen = bool(out[-1])
        return out[:k], out[k:2 * k] > 0

    def run_many(self, n: int, until_stop: bool = False) -> np.ndarray:
        """n epochs in chunks of at most ``max_chunk`` (the last shorter);
        returns their losses.  ``until_stop`` ends after a chunk whose last
        epoch raised the stop flag."""
        losses, done = [np.zeros(0, np.float32)], 0
        while done < n:
            k = min(self.max_chunk, n - done)
            chunk, stops = self.run(k)
            losses.append(chunk)
            done += k
            if until_stop and stops[-1]:
                break
        return np.concatenate(losses)


def chunk_step(
    loss_fn: Callable[[], torch.Tensor],
    leaves: List[torch.Tensor],
    optimizer,
    devices: Sequence[torch.device | str],
    per_call: int,
    max_chunk: int | None = None,
) -> Callable[..., np.ndarray]:
    """``chunk(k=per_call)``: k Adam steps on ``leaves``, each on the
    gradient of ``loss_fn()`` (a 0-d tensor on ``devices[0]``), updating
    them in place; returns the k losses (before each update) as a float32
    host array, read once.  ``max_chunk`` (default ``per_call``) is the
    longest chunk it takes.  On one card the epochs are one captured CUDA
    graph replayed k times; ``chunk.runner`` is the ``ChunkRunner``."""

    def step() -> torch.Tensor:
        loss = loss_fn()
        optimizer.step(torch.autograd.grad(loss, leaves))
        return loss.detach()

    K = max(1, int(per_call))
    runner = ChunkRunner(step, devices, max(K, max_chunk or K), optimizer=optimizer)

    def chunk(k: int = K) -> np.ndarray:
        return runner.run(k)[0]

    chunk.runner = runner
    return chunk
