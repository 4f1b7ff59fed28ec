"""The launch geometry of K4 (``csrc/banded_stream.cu``, a shared-memory
ring) and K1 (``csrc/block_ell_gather.cu``, a direct gather), computed in
Python and checked here on the CPU for every shape ``chip_smoke.py`` runs,
and the ops' routing: a tensor off the CPU reaches only those launchers,
and P3 (``subblock_spmm``) and P4 (``panel_ell_spmm``) only their new
kernels, not their earlier bodies.
"""

import pytest
import torch

from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.bench import microbench as micro
from gcn_maxcut_tpu_torch.experiments import weighted_probe
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES

BENCH = micro.banded_offsets(8, 63)
GIANT = tgiant.circulant_offsets(8, 63, 0)
PROBE = weighted_probe.probe_offsets()

# K4: (n, F, offsets) of chip_smoke.py's K4 phase (forward, and dx on the
# same shape), bench --what banded (131,072 and 1,250,304), P5b and the
# card tests' cases
K4_SHAPES = [
    (131_072, 128, BENCH), (1_250_304, 128, BENCH), (131_072, 3, BENCH), (296, 20, BENCH),
    (131_072, 128, PROBE), (4096, 16, GIANT), (2048, 3, (2, -7, 9)), (128, 12, (64, -64, 3)),
    (5000, 16, (1, -1, 5, -5, 63, -63)), (2000, 5, (40, -3)),
    (4096, 130, BENCH), (3000, 32, (5,)), (40, 8, (7, -7, 16, -16)),
    (1000, 8, (7, -7, 60, -60)), (300_000, 8, (1, -1, 5, -5, 63, -63)),
]
# K1: (n, F, block, Wp, width) of the locality plan (B = 512, Wp = 320,
# width 8, at F = 64 and 3), the microbenchmark plan (B = 256, Wp = 192,
# width 8, at F = 128 and 3), chip_smoke.py's small plans and the card
# tests' tables
K1_SHAPES = [
    (100_352, 64, 512, 320, 8), (100_352, 3, 512, 320, 8),
    (100_352, 128, 256, 192, 8), (100_352, 3, 256, 192, 8),
    (1200, 16, 240, 40, 4), (1200, 3, 240, 40, 4), (2048, 16, 256, 64, 1),
    (4096, 16, 512, 64, 1), (4096, 3, 512, 64, 1), (2048, 3, 256, 128, 6),
    (1280, 64, 256, 320, 8), (2048, 130, 256, 128, 3), (2048, 5, 512, 192, 8),
]


def _check_geometry(g: tb.StreamGeometry, n: int, F: int, wp: int, D: int) -> None:
    # the C launcher's own sum of the shared memory, and the card's limit
    assert g.smem_bytes == -(-g.ring_rows * g.cols * 4 // 16) * 16 + 2 * g.chunk * D * 4
    assert g.smem_bytes <= 232_448
    # the ring holds the current chunk's window plus the next chunk's rows
    assert g.chunk == tb.STREAM_CHUNK
    assert g.ring_rows == (g.chunk + 2 * wp) + g.chunk
    # the grid covers every row and column, with no empty strip or tile
    strips, tiles = g.grid
    assert strips * g.strip >= n > (strips - 1) * g.strip
    assert tiles * g.cols >= F > (tiles - 1) * g.cols
    assert g.strip % g.chunk == 0
    # a thread owns 4 columns: 16-byte accesses only
    assert F % 4 == 0
    assert g.cols % 4 == 0 and g.cols // 4 <= tb.STREAM_THREADS


@pytest.mark.parametrize("n,F,offsets", K4_SHAPES)
def test_k4_geometry(n, F, offsets):
    wp = tb.padded_bandwidth(offsets)
    assert 2 * wp <= n
    if F % 4:
        # such rows go to the earlier body: the ring has no geometry
        with pytest.raises(ValueError, match="16-byte"):
            tb.stream_shape(n, F, wp, len(offsets))
        return
    _check_geometry(tb.stream_shape(n, F, wp, len(offsets)), n, F, wp, len(offsets))


@pytest.mark.parametrize("n,F,block,wp,width", K1_SHAPES)
def test_k1_geometry(n, F, block, wp, width):
    # the planner's rules that the gather's slice test relies on
    r0 = tbell.sub_block_rows(block)
    assert n % block == 0 and block % r0 == 0 and r0 + 2 * wp <= block + 2 * wp <= n
    # one thread per (receiver row, vec columns): the blocks cover them all
    # and no block is empty; 16-byte loads only when F % 4 == 0
    vec, blocks = tbell.gather_shape(n, F)
    assert vec == (4 if F % 4 == 0 else 1)
    threads = n * (F // vec)
    assert blocks * tbell.GATHER_THREADS >= threads > (blocks - 1) * tbell.GATHER_THREADS
    assert tbell.gather_shape(n, F, vec4=False) == (1, -(-n * F // tbell.GATHER_THREADS))


def test_geometry_at_the_main_shapes():
    # K4 at bench --what banded's F = 128, Wp = 56: the 16-byte path, 64
    # columns, strips of 1024 rows at both sizes, so x is read
    # (1024 + 112)/1024 times, against (32 + 112)/32 by the 32-row tiles
    for n in (131_072, 1_250_304):
        g = tb.stream_shape(n, 128, 56, 8)
        assert (g.cols, g.chunk, g.strip, g.ring_rows) == (64, 64, 1024, 240)
        assert g.grid == (-(-n // 1024), 2)
    # F = 3 has no ring (the earlier body takes it); n below the chunk
    # gives one strip longer than n
    with pytest.raises(ValueError, match="16-byte"):
        tb.stream_shape(131_072, 3, 56, 8)
    assert tb.stream_shape(40, 8, 16, 4).grid == (1, 1)
    # K1 at the locality plan (F = 64 and 3) and the microbenchmark's
    # (F = 128): 16-byte loads where F allows
    assert tbell.gather_shape(100_352, 64) == (4, 6272)
    assert tbell.gather_shape(100_352, 3) == (1, 1176)
    assert tbell.gather_shape(100_352, 128) == (4, 12_544)


def test_geometry_rejects_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        tb.stream_shape(10**6, 4, 30_000, 8)
    # the widest tile is halved until the ring fits
    g = tb.stream_shape(100_352, 128, 512, 8)
    assert g.cols < tb.STREAM_COLS and g.smem_bytes <= tb.SMEM_LIMIT
    assert tb.stream_smem_bytes(g.ring_rows, 2 * g.cols, 8) > tb.SMEM_LIMIT


def _on_card(monkeypatch, module, name):
    """Record calls of ``module.name`` in place of the launch."""
    calls = []

    def fake(x, *args, **kw):
        calls.append(name)
        return torch.zeros(x.shape, dtype=x.dtype)

    monkeypatch.setattr(module, name, fake)
    return calls


def _fail(*args, **kw):
    raise AssertionError("a tensor off the CPU reached a kernel off the op's path")


def test_ops_off_the_cpu_reach_only_the_streaming_kernels(monkeypatch):
    calls = _on_card(monkeypatch, tb, "_stream_launch")
    monkeypatch.setattr(tb, "_launch", _fail)
    meta = torch.device("meta")
    x = torch.empty(4096, 16, device=meta)
    w = torch.empty(4096, 4, device=meta)
    tb._weighted_raw(x, w, (1, -1, 5, -5))
    assert calls == ["_stream_launch"]

    calls = _on_card(monkeypatch, tbell, "_launch")
    monkeypatch.setattr(tbell, "_add_outliers", lambda y, *a: y)
    sidx = torch.empty(4096, 8, dtype=torch.int32, device=meta)
    op = tbell.BlockEllOperand(sidx, torch.empty(4096, 8, device=meta), None, None, None, 512, 64)
    tbell._raw(x, op, 4096)
    assert calls == ["_launch"]


def test_subblock_spmm_keeps_the_slice_kernel(monkeypatch):
    # P3 measures 128-row slices; off the CPU it runs them from its ring
    # (csrc/subblock_stream.cu), never K1's gather
    calls = _on_card(monkeypatch, tpk, "_subblock_stream_launch")
    monkeypatch.setattr(tbell, "_launch", _fail)
    monkeypatch.setattr(tpk, "_dispatch", lambda name, x: False)
    monkeypatch.setattr(tpk, "_check_cuda", lambda name, *t: None)
    n, block, wp = 2048, 256, 64
    x = torch.zeros(n, 16)
    sidx = torch.zeros(n, 4, dtype=torch.int32)
    before = dict(LAUNCHES)
    tpk.subblock_spmm(x, sidx, torch.ones(n, 4), n, block, wp)
    assert calls == ["_subblock_stream_launch"]
    assert LAUNCHES == {**before, "subblock_spmm": before["subblock_spmm"] + 1}


def test_panel_ell_spmm_reaches_only_the_gather(monkeypatch):
    # P4 off the CPU runs panel_ell_gather and no other launcher
    calls = _on_card(monkeypatch, tpk, "_panel_gather_launch")
    monkeypatch.setattr(tpk, "_fn", _fail)
    monkeypatch.setattr(tpk, "_dispatch", lambda name, x: False)
    monkeypatch.setattr(tpk, "_check_cuda", lambda name, *t: None)
    n, block, wp, w_p = 2048, 256, 64, 3
    x = torch.zeros(n, 16)
    idx = torch.full((n, 3 * w_p), -1, dtype=torch.int32)
    before = dict(LAUNCHES)
    tpk.panel_ell_spmm(x, idx, torch.zeros(n, 3 * w_p), n, block, wp, w_p)
    assert calls == ["_panel_gather_launch"]
    assert LAUNCHES == {**before, "panel_ell_spmm": before["panel_ell_spmm"] + 1}
