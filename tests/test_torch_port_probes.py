"""Port parity: the SpMM design probes (P1–P5).

The port's plain versions (the CPU path of each wrapper in
``gcn_maxcut_tpu_torch/ops/probe_kernels.py``) are held against the JAX
probes in ``experiments/`` run in Pallas interpret mode, on inputs made
from a numpy seed, at rtol = atol = 1e-5: the interpret-mode kernels sum
through a one-hot matrix product in float32, in another order.  P1/P2's
kernels live in closures, so the test wraps each module's own ``_kernel``
in the probe's ``pallas_call``.  Interpret mode computes the "default"
precision in float32, so the bf16-x mode is held against JAX fed x already
rounded to bf16.  The CUDA kernels are held against the plain versions by
tests/test_torch_port_cuda.py and chip_smoke.py on the card.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import gcn_maxcut_tpu.utils.cache as jcache
from gcn_maxcut_tpu_torch.experiments import (
    gather_probe,
    gather_probe2,
    panel_ell_probe,
    subblock_probe,
    weighted_probe,
)
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES

ROOT = Path(__file__).resolve().parent.parent
N, F, D, W, B = 2048, 16, 8, 31, 256


@pytest.fixture(scope="module")
def jprobes():
    """The JAX probes, loaded by path.  Importing gather_probe(2) turns on
    JAX's persistent compilation cache, which must stay off in tests."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
        for name in ("gather_probe", "gather_probe2", "subblock_probe", "panel_ell_probe",
                     "weighted_probe"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_probe_{name}", ROOT / "experiments" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    return mods


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_window_gather(mod, mode, lidx, w, xpad, block, wp):
    """The probe's pallas_call (gather_probe.py:169-186) around its _kernel."""
    n, d = lidx.shape
    Fx = xpad.shape[1]
    nb = n // block
    win = block + 2 * wp
    kern = functools.partial(mod._kernel, block, wp, Fx, 128, nb, d, mode)
    with pltpu.force_tpu_interpret_mode():
        y = pl.pallas_call(
            kern,
            grid=(nb,),
            in_specs=[
                pl.BlockSpec((block, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((block, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pl.ANY),
            ],
            out_specs=pl.BlockSpec((block, Fx), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n, Fx), jnp.float32),
            scratch_shapes=[pltpu.VMEM((2, win, Fx), jnp.float32), pltpu.SemaphoreType.DMA((2,))],
            compiler_params=pltpu.CompilerParams(has_side_effects=True,
                                                 vmem_limit_bytes=64 * 1024 * 1024),
        )(jnp.asarray(lidx), jnp.asarray(w), jnp.asarray(xpad))
    return np.asarray(y)


# (probe, JAX mode, bf16 x): P1's precisions, P2's modes
WINDOW_CASES = [("gather_probe", "highest", False), ("gather_probe", "default", True),
                ("gather_probe2", "split", False), ("gather_probe2", "high", False),
                ("gather_probe2", "default", True)]


@pytest.mark.parametrize("probe,mode,bf16", WINDOW_CASES)
def test_window_gather_matches_jax_interpret(jprobes, probe, mode, bf16):
    if probe == "gather_probe":
        _, lidx, n_use, wp = gather_probe.block_table(W, B, n=N, d=D)
    else:
        _, lidx, n_use, wp = gather_probe2.block_table(W, B, d=D, n=N)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_use, F)).astype(np.float32)
    if bf16:
        x = _bf16(x)
    w = (rng.random((n_use, D)) + 0.5).astype(np.float32)
    xpad = np.pad(x, ((wp, wp), (0, 0)))
    yj = _jax_window_gather(jprobes[probe], mode, lidx, w, xpad, B, wp)
    xt = torch.from_numpy(xpad)
    yt = tpk.window_gather(xt.bfloat16() if bf16 else xt, torch.from_numpy(lidx),
                           torch.from_numpy(w), B, wp)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_subblock_matches_jax_interpret(jprobes):
    wp = 32
    rng = np.random.default_rng(4)
    i = np.arange(N)[:, None]
    # senders up to 40 rows beyond the 128-row slice, across the wrap: both drop them
    sidx = ((i + rng.integers(-wp - 40, wp + 41, size=(N, D))) % N).astype(np.int32)
    w = (rng.random((N, D)) + 0.5).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jprobes["subblock_probe"].sub_spmm(
            jnp.asarray(x), jnp.asarray(sidx), jnp.asarray(w), N, B, wp))
    yt = tpk.subblock_spmm(torch.from_numpy(x), torch.from_numpy(sidx), torch.from_numpy(w),
                           N, B, wp)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def _panel_inputs(seed=5):
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(N), D)
    s = (i + rng.integers(-W, W + 1, size=i.shape[0])) % N
    s[:5] = (i[:5] + N // 2) % N                 # a few edges escape the window
    w = (rng.random(i.shape[0]) + 0.5).astype(np.float32)
    return s.astype(np.int32), i.astype(np.int32), w


@pytest.mark.parametrize("w_p", [1, 2, 4])
def test_build_panel_tables_matches_jax(jprobes, w_p):
    s, r, w = _panel_inputs()
    got = panel_ell_probe.build_panel_tables(s, r, w, N, B, 64, w_p)
    want = jprobes["panel_ell_probe"].build_panel_tables(s, r, w, N, B, 64, w_p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("w_p", [2, 4])
def test_panel_matches_jax_interpret(jprobes, w_p):
    s, r, w = _panel_inputs()
    idx, wgt, _, _ = panel_ell_probe.build_panel_tables(s, r, w, N, B, 64, w_p)
    x = np.random.default_rng(6).normal(size=(N, F)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jprobes["panel_ell_probe"].panel_spmm(
            jnp.asarray(x), jnp.asarray(idx), jnp.asarray(wgt), N, B, 64, w_p))
    yt = tpk.panel_ell_spmm(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(wgt),
                            N, B, 64, w_p)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["blockw", "cols", "mxu1", "mxuall", "hybrid4"])
def test_weighted_variant_matches_jax_interpret(jprobes, variant):
    offsets = weighted_probe.probe_offsets(D, W)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = (rng.random((N, D)) + 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jprobes["weighted_probe"].weighted_variant(
            jnp.asarray(x), jnp.asarray(w), offsets, variant, block=B))
    yt = weighted_probe.weighted_variant(torch.from_numpy(x), torch.from_numpy(w), offsets,
                                         variant)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_probe_offsets_match_jax(jprobes):
    rng = np.random.default_rng(0)
    half = rng.choice(np.arange(1, jprobes["weighted_probe"].W + 1), size=D // 2, replace=False)
    assert weighted_probe.probe_offsets() == tuple(
        int(o) for pair in ((s, -s) for s in half) for o in pair)


# ---- the wrappers on the CPU: plain versions only, nothing counted ----------

def test_wrappers_take_the_plain_path_on_cpu_and_raise_elsewhere():
    rng = np.random.default_rng(8)
    n, wp = 512, 16
    xpad = torch.tensor(rng.normal(size=(n + 2 * wp, 8)).astype(np.float32))
    lidx = torch.tensor(rng.integers(0, 128 + 2 * wp, size=(n, 4)).astype(np.int32))
    w = torch.ones(n, 4)
    before = dict(LAUNCHES)
    assert torch.equal(tpk.window_gather(xpad, lidx, w, 128, wp),
                       tpk.window_gather_plain(xpad, lidx, w, 128, wp))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpk.window_gather(xpad.to("meta"), lidx.to("meta"), w.to("meta"), 128, wp)
    with pytest.raises(ValueError, match="geometry"):
        tpk.window_gather(xpad, lidx, w, 100, wp)
    with pytest.raises(ValueError, match="slots"):
        tpk.panel_ell_spmm(torch.zeros(n, 8), lidx, w, n, 128, 64, 3)
    with pytest.raises(ValueError, match="wc must be"):
        tpk.banded_spmm_cols(torch.zeros(n, 8), torch.ones(n, 2), (1, -1))


def test_window_gather_skips_slots_outside_the_window():
    n, wp, blk = 256, 8, 128
    xpad = torch.arange((n + 2 * wp) * 2, dtype=torch.float32).reshape(-1, 2)
    lidx = torch.tensor([[0, -1, blk + 2 * wp]] * n, dtype=torch.int32)
    y = tpk.window_gather(xpad, lidx, torch.ones(n, 3), blk, wp)
    base = torch.arange(n) // blk * blk
    assert torch.equal(y, xpad[base])


# ---- the slice as a whole: every probe entry point on the CPU --------------

@pytest.mark.parametrize("probe", [gather_probe, gather_probe2, subblock_probe,
                                   panel_ell_probe, weighted_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_entry_point_runs_on_cpu(probe, capsys):
    res = probe.main(n=N, iters=1, device="cpu")
    assert res["device"] == "cpu" and res["n"] == N
    out = capsys.readouterr().out
    if probe in (gather_probe, gather_probe2):
        assert len(res["block_ell"]) == out.count("block-ELL W=")
        for row in res["block_ell"]:
            assert row["relerr"] <= (1e-2 if row["x_dtype"] == "bfloat16" else 1e-6)
    elif probe is subblock_probe:
        assert [row["W"] for row in res["configs"]] == [255, 511]
        for row in res["configs"]:
            for design in ("sub-blocked", "whole window"):
                assert row[design]["relerr"] <= 1e-5
    elif probe is panel_ell_probe:
        panel = [row for row in res["rows"] if row["design"] == "panel-ELL"]
        assert {row["W"] for row in panel} == {255, 511}
        assert all(row["relerr"] <= 1e-5 for row in panel)
    else:
        assert set(res["variants"]) == set(weighted_probe.VARIANTS)
        for variant, row in res["variants"].items():
            exact = variant in ("blockw", "fullw", "hoist", "cols", "mxuall3")
            assert row["rel_err"] <= (1e-6 if exact else 1e-2)
