"""Port parity: the native toolkit's bindings and the regular sampler's dispatch.

Both packages call ``native/libgraphtools.so``; the port through its own
ctypes bindings (``gcn_maxcut_tpu_torch/native/bindings.py``).  Every
output is held equal array for array to the JAX package's bindings on the
same numpy inputs.  The load-or-build rule is checked with the committed
library's path pointed at a file that does not load.
"""

import numpy as np
import pytest

from gcn_maxcut_tpu.data import generate as jgen
from gcn_maxcut_tpu.native import bindings as jnat
from gcn_maxcut_tpu_torch.data import generate as tgen
from gcn_maxcut_tpu_torch.native import bindings as tnat


def _coo(n, d, seed):
    e = jgen.random_regular_edges(n, d, seed=seed)
    return np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])


def _symmetric_weights(s, r, seed):
    # one weight per undirected edge, the same on both directions
    rng = np.random.default_rng(seed)
    lo, hi = np.minimum(s, r), np.maximum(s, r)
    _, inv = np.unique(lo * (hi.max() + 1) + hi, return_inverse=True)
    return rng.random(inv.max() + 1).astype(np.float32)[inv]


def test_sampler_matches_jax_from_20000():
    # the JAX package switches to the native sampler at n = 20,000
    for n in (19_998, 20_000):
        np.testing.assert_array_equal(tgen.random_regular_edges(n, 3, seed=0),
                                      jgen.random_regular_edges(n, 3, seed=0))
    np.testing.assert_array_equal(tnat.random_regular_edges_native(20_000, 3, seed=5),
                                  jnat.random_regular_edges_native(20_000, 3, seed=5))


def test_unseeded_draw_is_not_the_seed_0_graph():
    seeded = tgen.random_regular_edges(20_000, 3, seed=0)
    a = tgen.random_regular_edges(20_000, 3)
    b = tgen.random_regular_edges(20_000, 3)
    assert not np.array_equal(a, seeded)
    assert not np.array_equal(a, b)
    assert np.all(np.bincount(a.ravel(), minlength=20_000) == 3)


def test_sort_by_receiver_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    w = rng.random(300).astype(np.float32)
    for ww in (w, None):
        got = tnat.sort_by_receiver_native(src, dst, 50, ww)
        ref = jnat.sort_by_receiver_native(src, dst, 50, ww)
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_out_of_range_node_ids_raise():
    s, r = _coo(50, 4, 0)
    bad = r.copy()
    bad[0] = 50
    for fn in (lambda: tnat.bfs_partition_native(s, bad, 50, 2),
               lambda: tnat.metis_partition_native(s, bad, 50, 2),
               lambda: tnat.sort_by_receiver_native(s, bad - 100, 50)):
        with pytest.raises(ValueError, match="node ids"):
            fn()


@pytest.mark.parametrize("D", [2, 4, 7])
def test_partitions_match_jax(D):
    s, r = _coo(500, 6, 1)
    np.testing.assert_array_equal(tnat.bfs_partition_native(s, r, 500, D),
                                  jnat.bfs_partition_native(s, r, 500, D))
    w = _symmetric_weights(s, r, 2)
    for weights, seed in ((None, 0), (w, 3)):
        np.testing.assert_array_equal(
            tnat.metis_partition_native(s, r, 500, D, weights=weights, seed=seed),
            jnat.metis_partition_native(s, r, 500, D, weights=weights, seed=seed))


def test_symmetry_check_matches_jax():
    s, r = _coo(200, 4, 3)
    w = _symmetric_weights(s, r, 4)
    bad_w = w.copy()
    bad_w[0] += 0.5
    cases = [(s, r, None, True), (s, r, w, True), (s, r, bad_w, False),
             (s[:-1], r[:-1], w[:-1], False)]          # one edge without its reverse
    for ss, rr, ww, expect in cases:
        got = tnat.symmetry_check_native(ss, rr, ww)
        assert got is jnat.symmetry_check_native(ss, rr, ww) is expect


@pytest.mark.parametrize("D,weighted,build_ell,budget", [
    (1, False, True, 1 << 30), (4, True, True, 1 << 30), (8, False, True, 1 << 30),
    (4, False, False, 1 << 30), (4, False, True, 1024),
], ids=["D1", "D4-weighted", "D8", "D4-no-ell", "D4-over-budget"])
def test_shard_assembly_matches_jax(D, weighted, build_ell, budget):
    n = 300
    s, r = _coo(n, 6, 5)
    w = _symmetric_weights(s, r, 6) if weighted else None
    owner = jnat.bfs_partition_native(s, r, n, D)
    kw = dict(weights=w, build_ell=build_ell, ell_budget_bytes=budget)
    got = tnat.shard_assembly_native(s, r, owner, n, D, **kw)
    ref = jnat.shard_assembly_native(s, r, owner, n, D, **kw)
    assert got.keys() == ref.keys()
    assert got["use_ell"] == ref["use_ell"] == (build_ell and budget > 1024)
    for k in got:
        if isinstance(ref[k], np.ndarray):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k


def test_library_builds_when_the_committed_one_does_not_load(tmp_path, monkeypatch):
    broken = tmp_path / "libgraphtools.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(tnat, "_COMMITTED", broken)
    monkeypatch.setattr(tnat, "BUILT", tmp_path / "build" / "libgraphtools.so")
    tnat.library.cache_clear()
    try:
        np.testing.assert_array_equal(tnat.random_regular_edges_native(100, 4, seed=7),
                                      jnat.random_regular_edges_native(100, 4, seed=7))
        assert tnat.BUILT.exists()
        # neither loads nor builds: every entry point raises, no fallback
        monkeypatch.setattr(tnat, "BUILT", tmp_path / "none" / "libgraphtools.so")
        monkeypatch.setenv("CXX", "false")
        tnat.library.cache_clear()
        assert not tnat.is_available()
        with pytest.raises(RuntimeError, match="neither loads"):
            tgen.random_regular_edges(20_000, 3, seed=0)
    finally:
        tnat.library.cache_clear()
