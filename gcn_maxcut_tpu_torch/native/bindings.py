"""ctypes bindings for the native host toolkit (``native/graphtools.cpp``).

Port of ``gcn_maxcut_tpu/native/bindings.py`` for the entry points the
sharded path runs: the d-regular sampler, the receiver sort, the BFS and
multilevel (METIS-style) partitions, the symmetry check and the two passes
of the shard assembly.  Both packages call the same library, so their
outputs are equal array for array.

The library is loaded from the committed ``native/libgraphtools.so``.  If
that file does not load on this machine, ``native/graphtools.cpp`` is
compiled with ``native/Makefile``'s flags into
``build/native/libgraphtools.so`` at the repository root (``native/`` is
never written).  If neither loads nor builds, every entry point raises:
there is no silent fallback to the Python sampler, which draws other
graphs.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
_COMMITTED = ROOT / "native" / "libgraphtools.so"
_SOURCE = ROOT / "native" / "graphtools.cpp"
BUILT = ROOT / "build" / "native" / "libgraphtools.so"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "gt_random_regular": (ctypes.c_int64, [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, _i32p, _i32p]),
    "gt_sort_by_receiver": (None, [ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _f32p]),
    "gt_bfs_partition": (None, [
        ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, ctypes.c_int32, _i32p]),
    "gt_metis_partition": (None, [
        ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _f32p,
        ctypes.c_int32, ctypes.c_float, ctypes.c_uint64, _i32p]),
    "gt_symmetry_check": (ctypes.c_int32, [ctypes.c_int64, _i32p, _i32p, _f32p]),
    "gt_shard_counts": (ctypes.c_int64, [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _i32p, _i32p, _i32p,
        ctypes.c_int64, _i32p, _i64p, _i64p, _i32p]),
    "gt_shard_fill": (None, [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _f32p, _i32p, _i32p,
        _i64p, _i32p, _i32p, _i32p, _f32p, _f32p, _f32p, _i32p, _f32p, _f32p]),
}


def _build() -> Path:
    """Compile the toolkit into ``BUILT`` (atomically: concurrent builds
    each write a temporary file and rename it)."""
    BUILT.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILT.parent)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {_SOURCE} failed:\n{proc.stderr}")
    os.replace(tmp, BUILT)
    return BUILT


@functools.cache
def library() -> ctypes.CDLL:
    """The toolkit: the committed library, else one built from the source.
    Raises ``RuntimeError`` when neither loads."""
    try:
        lib = ctypes.CDLL(str(_COMMITTED))
    except OSError as committed_error:
        try:
            lib = ctypes.CDLL(str(BUILT if BUILT.exists() else _build()))
        except (OSError, RuntimeError) as e:
            raise RuntimeError(
                f"the native toolkit neither loads ({committed_error}) nor builds ({e})"
            ) from e
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def is_available() -> bool:
    try:
        library()
    except RuntimeError:
        return False
    return True


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ids(n: int, *arrays: np.ndarray) -> list[np.ndarray]:
    """int32 copies of node-id arrays, checked to lie in [0, n): the C
    routines index their buffers with them unchecked."""
    out = [_i32(a) for a in arrays]
    for a in out:
        if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
            raise ValueError(f"node ids must lie in [0, {n})")
    return out


def _f32_or_none(a: np.ndarray | None) -> np.ndarray | None:
    return None if a is None else np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray | None, typ):
    return None if a is None else a.ctypes.data_as(typ)


def random_regular_edges_native(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Undirected edge list [m, 2] (src < dst), lexsorted.  Raises
    ``RuntimeError`` when the sampler gives up (its restart budget)."""
    lib = library()
    m = n * d // 2
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    got = lib.gt_random_regular(n, d, seed, _ptr(src, _i32p), _ptr(dst, _i32p))
    if got < 0:
        raise RuntimeError(f"native regular sampler failed (n={n}, d={d})")
    edges = np.stack([src, dst], axis=1).astype(np.int64)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


def sort_by_receiver_native(
    src: np.ndarray, dst: np.ndarray, n: int, w: np.ndarray | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Stable counting sort of a directed COO list by receiver."""
    lib = library()
    s, d = (a.copy() for a in _ids(n, src, dst))
    ww = None if w is None else _f32_or_none(w).copy()
    lib.gt_sort_by_receiver(s.shape[0], n, _ptr(s, _i32p), _ptr(d, _i32p), _ptr(ww, _f32p))
    return s, d, ww


def bfs_partition_native(src: np.ndarray, dst: np.ndarray, n: int, num_shards: int) -> np.ndarray:
    """BFS-grown blocks of ceil(n / D) nodes (``partition_nodes_bfs``'s rule)."""
    lib = library()
    s, d = _ids(n, src, dst)
    owner = np.empty(n, dtype=np.int32)
    lib.gt_bfs_partition(n, s.shape[0], _ptr(s, _i32p), _ptr(d, _i32p), num_shards,
                         _ptr(owner, _i32p))
    return owner.astype(np.int64)


def metis_partition_native(
    senders: np.ndarray, receivers: np.ndarray, n: int, num_parts: int,
    weights: np.ndarray | None = None, imbalance: float = 0.03, seed: int = 0,
) -> np.ndarray:
    """Multilevel partition of the directed COO (both edge directions):
    heavy-edge-matching coarsening, a BFS initial partition, boundary
    refinement at each level.  ``imbalance`` is a target, not enforced:
    parts may exceed it."""
    lib = library()
    src, dst = _ids(n, senders, receivers)
    w = _f32_or_none(weights)
    owner = np.zeros(n, dtype=np.int32)
    lib.gt_metis_partition(n, src.shape[0], _ptr(src, _i32p), _ptr(dst, _i32p),
                           _ptr(w, _f32p), num_parts, imbalance, seed, _ptr(owner, _i32p))
    return owner.astype(np.int64)


def symmetry_check_native(
    senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray | None
) -> bool:
    """Order-independent hashed Aᵀ = A check of a directed COO, one pass."""
    lib = library()
    src, dst, w = _i32(senders), _i32(receivers), _f32_or_none(weights)
    return bool(lib.gt_symmetry_check(src.shape[0], _ptr(src, _i32p), _ptr(dst, _i32p),
                                      _ptr(w, _f32p)))


def shard_assembly_native(
    senders: np.ndarray,
    receivers: np.ndarray,
    owner: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    edge_pad_multiple: int = 128,
    build_ell: bool = True,
    ell_budget_bytes: int = 1 << 30,
) -> dict:
    """O(E) assembly of the node-sharded edge-group buffers: a counting sort
    by (receiver shard, ring hop, local receiver), equal bit for bit to
    ``parallel.partition.shard_graph``'s numpy lane, with the same ELL
    byte budget and skew ceiling.  Returns the stacked host arrays."""
    lib = library()

    def _round_up(x: int, m: int) -> int:
        return ((x + m - 1) // m) * m if x else 0

    src, dst, own = _i32(senders), _i32(receivers), _i32(owner)
    e = src.shape[0]
    w = _f32_or_none(weights)
    sizes = np.bincount(own, minlength=num_shards)
    n_shard = max(_round_up(int(sizes.max()) if sizes.size else 0, 8), 8)

    D = num_shards
    local = np.empty(n, dtype=np.int32)
    shard_sizes = np.empty(D, dtype=np.int64)
    counts = np.empty(D * D, dtype=np.int64)
    deg_group = np.zeros(D * D * n_shard, dtype=np.int32)
    ell_w = lib.gt_shard_counts(
        e, n, D, _ptr(src, _i32p), _ptr(dst, _i32p), _ptr(own, _i32p),
        n_shard, _ptr(local, _i32p), _ptr(shard_sizes, _i64p),
        _ptr(counts, _i64p), _ptr(deg_group, _i32p),
    )
    if ell_w < 0:
        raise ValueError("shard assembly: node id or owner out of range")

    e_group = _round_up(int(counts.max()) if counts.size else 0, edge_pad_multiple)
    nz = int(np.count_nonzero(deg_group))
    mean_deg = (e / nz) if nz else 0.0
    ell_bytes = 3 * 4 * D * D * n_shard * int(ell_w)
    use_ell = (
        build_ell and ell_w > 0
        and ell_bytes <= ell_budget_bytes
        and ell_w <= max(8.0, 8.0 * mean_deg)
    )
    ell_w_eff = int(ell_w) if use_ell else 0

    S = np.empty((D, D, e_group), dtype=np.int32)
    R = np.empty_like(S)
    W = np.empty((D, D, e_group), dtype=np.float32)
    M = np.empty_like(W)
    degrees = np.empty((D, n_shard), dtype=np.float32)
    if use_ell:
        ES = np.empty((D, D, n_shard, ell_w_eff), dtype=np.int32)
        EW = np.empty((D, D, n_shard, ell_w_eff), dtype=np.float32)
        EM = np.empty_like(EW)
    else:
        ES = EW = EM = None
    lib.gt_shard_fill(
        e, n, D, n_shard, e_group, ell_w_eff,
        _ptr(src, _i32p), _ptr(dst, _i32p), _ptr(w, _f32p),
        _ptr(own, _i32p), _ptr(local, _i32p),
        _ptr(counts, _i64p), _ptr(deg_group, _i32p),
        _ptr(S, _i32p), _ptr(R, _i32p), _ptr(W, _f32p), _ptr(M, _f32p),
        _ptr(degrees, _f32p), _ptr(ES, _i32p), _ptr(EW, _f32p), _ptr(EM, _f32p),
    )
    return {
        "local": local.astype(np.int64),
        "shard_sizes": shard_sizes,
        "n_shard": n_shard,
        "e_group": e_group,
        "S": S, "R": R, "W": W, "M": M,
        "degrees": degrees,
        "ES": ES, "EW": EW, "EM": EM,
        "use_ell": use_ell,
    }
