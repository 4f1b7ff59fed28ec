"""Debug helpers: port of ``gcn_maxcut_tpu/utils/debug.py``.

``debug_mode`` turns on autograd's anomaly detection, where the JAX one
sets ``jax_debug_nans``/``jax_debug_infs``: a backward that produces a NaN
raises and names the forward operation that led to it.  Anomaly detection
has no separate check for infinities, so there is no ``infs`` argument.

``checked`` wraps a chunk of epochs (``train/chunks.py``), as the JAX one
wraps a jitted function with ``checkify``: inside a CUDA graph nothing
raises where it happens, so a device flag records any non-finite loss or
gradient of the chunk, and the wrapper raises after the chunk, once its
results are read, as ``err.throw()`` does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Anomaly detection on inside the context (the previous setting is
    restored on exit)."""
    with torch.autograd.set_detect_anomaly(nans, check_nan=nans):
        yield


def checked(fn: Callable) -> Callable:
    """Wrap a chunk callable: a ``ChunkRunner``'s ``run``, or the chunk
    that ``make_giant_step`` or ``make_hybrid_step`` returns, which carries
    its runner as ``.runner``.  Wrap it before its first chunk.
    The wrapper returns what ``fn`` returns and raises
    ``FloatingPointError`` after a chunk in which a loss or a gradient
    was NaN or infinite."""
    runner = getattr(fn, "runner", None) or getattr(fn, "__self__", None)
    if runner is None or not hasattr(runner, "enable_check"):
        raise TypeError("checked() wraps a ChunkRunner.run or a chunk with a .runner")
    runner.enable_check()

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if runner.nonfinite_seen:
            raise FloatingPointError("non-finite loss or gradient in the chunk")
        return out

    wrapper.runner = runner
    return wrapper


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in the JAX ``keystr`` notation and JAX's leaf order:
    ``['key']`` for a dict entry (keys sorted), ``[i]`` for a list or tuple
    element."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` (tensors or arrays in nested dicts, lists and tuples) that holds
    a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name} at {path}")
