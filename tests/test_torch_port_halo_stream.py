"""K5 and K6 on the card run ``csrc/halo_stream.cu``, which streams each
strip of a shard's rows into shared memory in chunks, on every shard whose
rows take 16-byte copies (the earlier body takes the rest).  Checked here
on the CPU: the launch geometry (``ops/halo.halo_stream_shape``) for every
shard ``chip_smoke.py`` and the card tests launch, the 16-byte rule, a
pure-Python walk of the kernel's slot arithmetic against the plain version
bit for bit, and that CUDA shards reach the ops' launcher once each, under
their op's launch counter.
"""

import pytest
import torch

from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.bench import microbench as micro
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh

GIANT = tgiant.circulant_offsets(8, 63, 0)
BENCH = micro.banded_offsets(8, 63)

# (m, L, offsets, weighted) of one shard: chip_smoke.py's K5 rows (the
# weighted microbenchmark shard at 1, 2 and 4 shards, the plain halo
# trainer's at F = 128 and 3), its K6 rows (the packed halo trainer's shard
# of 1, 2 and 4 at L = 128), the smoke's small packed runs (bandwidth 31),
# and the card tests' shards
SHARDS = [
    (131_072, 128, BENCH, True), (65_536, 128, BENCH, True), (32_768, 128, BENCH, True),
    (262_144, 128, GIANT, False), (262_144, 3, GIANT, False),
    (1_250_304, 128, GIANT, False), (625_152, 128, GIANT, False), (312_576, 128, GIANT, False),
    (32, 128, (31, -31, 1, -1), False), (128, 128, (31, -31, 1, -1), False),
    (4096, 128, BENCH, True), (4096, 16, (1, -1, 5, -5, 63, -63), True),
    (2048, 3, BENCH, True), (64, 20, (1, -1, 7, -7, 60, -60), True),
    (512, 128, (63, -63, 1, -1), False), (1024, 128, (9, -9, 2, -2, 33, -33), False),
    (128, 24, (2, -2, 9, -9), False), (40, 16, (1, -1, 5, -5), True),
    (1000, 32, (7, -7, 60, -60), True), (300_000, 8, (1, -1, 5, -5, 63, -63), True),
    (296, 3, (1, -1, 7, -7), True), (1024, 16, (1, -1, 5, -5), False),
]


def _check_geometry(g: th.HaloStreamGeometry, m, L, wp, D, elsize) -> None:
    # the C launcher's own sum of the shared memory, and the card's limit
    assert g.smem_bytes == -(-g.window_rows * g.cols * elsize // 16) * 16 + 2 * g.chunk * D * 4
    assert g.smem_bytes == th.halo_stream_smem_bytes(g.window_rows, g.cols, elsize, D)
    assert g.smem_bytes <= 232_448
    # the window holds the strip's rows and its halo (the C launcher's
    # strip + 2·Wp): chunk 0's window plus the second chunk's rows
    assert g.chunk == th.HALO_CHUNK and g.chunk % 4 == 0
    assert g.window_rows == g.strip + 2 * wp == 2 * g.chunk + 2 * wp
    # the grid covers every row and column, with no empty strip or tile
    strips, tiles = g.grid
    assert strips * g.strip >= m > (strips - 1) * g.strip
    assert tiles * g.cols >= L > (tiles - 1) * g.cols
    assert g.strip == th.HALO_STRIP and g.strip % g.chunk == 0
    # a thread owns 16 bytes of one row
    assert g.vec == 16 // elsize
    assert g.cols % g.vec == 0 and g.cols // g.vec <= th.HALO_THREADS
    assert g.cols <= th.HALO_COLS and L * elsize % 16 == 0


@pytest.mark.parametrize("m,L,offsets,weighted", SHARDS)
def test_halo_stream_geometry(m, L, offsets, weighted):
    wp = th.padded_bandwidth(offsets)
    D = len(offsets) if weighted else 0
    for elsize in (4, 2):
        if L * elsize % 16:
            # such shards go to the earlier body: the ring has no geometry
            with pytest.raises(ValueError, match="16-byte"):
                th.halo_stream_shape(m, L, wp, D, elsize)
            continue
        _check_geometry(th.halo_stream_shape(m, L, wp, D, elsize), m, L, wp, D, elsize)


def test_halo_stream_geometry_at_the_trainers_shards():
    # K6 at the packed halo trainer's shard (bandwidth 63, Wp = 56): 64
    # bf16 columns (128-byte rows) in two tiles, 16-byte copies of 8
    # values, strips of two 64-row chunks: 2,442 strips × 2 tiles
    assert th.padded_bandwidth(GIANT) == 56
    g = th.halo_stream_shape(312_576, 128, 56, 0, 2)
    assert (g.vec, g.cols, g.chunk, g.strip, g.window_rows) == (8, 64, 64, 128, 240)
    assert g.grid == (2442, 2) and g.smem_bytes == 30_720
    # K5 unit at F = 128, float32: 64 columns (256-byte rows), 4 values
    g = th.halo_stream_shape(262_144, 128, 56, 0, 4)
    assert (g.vec, g.cols, g.grid, g.smem_bytes) == (4, 64, (2048, 2), 61_440)
    # weighted K5: the ring and two chunks of [64, 8] weights
    g = th.halo_stream_shape(32_768, 128, 56, 8, 4)
    assert (g.window_rows, g.smem_bytes) == (240, 240 * 256 + 2 * 64 * 8 * 4)
    # a wide halo halves the tile until the ring fits, else it is refused
    g = th.halo_stream_shape(100_000, 128, 512, 8, 4)
    assert g.cols < 64 and g.smem_bytes <= th.SMEM_LIMIT
    assert th.halo_stream_smem_bytes(g.window_rows, 2 * g.cols, 4, 8) > th.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        th.halo_stream_shape(10**6, 4, 30_000, 8, 4)


def test_vec16_follows_the_width_and_every_address():
    # CPU tensors: the rule reads only the width and the data pointers
    flat = torch.zeros(4 * 1024 + 8)
    x = flat[:4096].view(256, 16)
    assert th._vec16(16, 4, x, x[8:], x[:8])
    assert not th._vec16(3, 4, x)                    # 12-byte rows
    assert not th._vec16(20, 2, x)                   # 40-byte rows
    assert th._vec16(20, 4, x) and th._vec16(24, 2, x)
    assert not th._vec16(16, 4, x, flat[1:17])       # one operand 4 bytes off
    assert not th._vec16(16, 4, flat[2:4098].view(-1, 16), x)
    # shards split from one [n, 3] tensor: pre/post views are misaligned
    shards = torch.zeros(4 * 37, 3).split(37)
    assert not th._vec16(3, 4, *shards)
    assert shards[1].data_ptr() % 16 and shards[1][37 - 8:].data_ptr() % 16


def _ring_walk(x, pre, post, offsets, w, chunk, strip, cols):
    """The kernel's schedule in Python: for each (strip, column tile) block
    the prologue loads chunk 0's window, then each chunk first loads the
    next chunk's rows into their slots (checked to be slots that no chunk
    has read, each written once), then sums its rows from the window in
    offset order (float32, separate multiply and add roundings), slot = t
    for strip-local row t, in a window of R = strip + 2·Wp rows."""
    m, L = x.shape
    wp = pre.shape[0]
    R = strip + 2 * wp
    out = torch.empty(m, L, dtype=torch.float32)

    def source(q):
        return pre[q + wp] if q < 0 else post[q - m] if q >= m else x[q]

    for s0 in range(0, m, strip):
        rows_here = min(strip, m - s0)
        need = rows_here + 2 * wp
        n_chunks = -(-rows_here // chunk)
        for c0 in range(0, L, cols):
            fc = min(cols, L - c0)
            window = torch.full((R, fc), float("nan"))
            written, read = set(), set()

            def load(t_lo, t_hi):
                for t in range(t_lo, min(t_hi, need)):
                    assert t < R and t not in written and t not in read
                    window[t] = source(s0 - wp + t)[c0:c0 + fc].float()
                    written.add(t)

            load(0, chunk + 2 * wp)
            for j in range(n_chunks):
                r = s0 + j * chunk
                rows = min(chunk, m - r)
                slots = [j * chunk + wp + torch.arange(rows) + o for o in offsets]
                for slot in slots:
                    assert bool((slot >= 0).all()) and bool((slot < need).all())
                    read.update(slot.tolist())
                if j + 1 < n_chunks:     # in flight while chunk j sums
                    load((j + 1) * chunk + 2 * wp, (j + 2) * chunk + 2 * wp)
                acc = torch.zeros(rows, fc)
                for k, slot in enumerate(slots):
                    v = window[slot]
                    acc = acc + (v if w is None else w[r:r + rows, k:k + 1] * v)
                out[r:r + rows, c0:c0 + fc] = acc
            assert written == set(range(need))
    assert not torch.isnan(out).any()
    return out.to(x.dtype)


# (m, L, offsets, weighted, (chunk, strip, cols) or None for the shipped
# geometry): several strips and chunks, partial last chunk and strip, m
# below a chunk, Wp = m, column tails
WALKS = [
    (200, 8, (1, -1, 5, -5, 15, -15), True, (8, 32, 4)),
    (37, 4, (1, -1, 7, -7), False, (4, 12, 4)),
    (16, 8, (7, -7, 16, -16), True, (4, 8, 4)),        # Wp = m
    (5, 4, (3, -8), False, (4, 4, 4)),                  # m below a chunk
    (130, 12, (2, -2, 9, -9), False, None),
    (300, 8, (40, -3), True, None),
]


@pytest.mark.parametrize("m,L,offsets,weighted,geom", WALKS)
def test_ring_walk_equals_plain(m, L, offsets, weighted, geom):
    gen = torch.Generator().manual_seed(m)
    wp = th.padded_bandwidth(offsets)
    x, pre, post = (torch.randn(rows, L, generator=gen) for rows in (m, wp, wp))
    w = torch.rand(m, len(offsets), generator=gen) + 0.5 if weighted else None
    if geom is None:
        g = th.halo_stream_shape(m, L, wp, len(offsets) if weighted else 0, 4)
        geom = (g.chunk, g.strip, g.cols)
    got = _ring_walk(x, pre, post, offsets, w, *geom)
    assert torch.equal(got, th.halo_banded_spmm_plain(x, w, pre, post, offsets))


def test_cuda_shards_reach_the_launcher_once_each(monkeypatch):
    # each CUDA shard reaches the launcher once, named by its op: the
    # launcher counts it under that op where its kernel launches
    calls = []

    def fake(x, pre, post, offsets, w=None, *, op):
        calls.append((tuple(x.shape), w is not None, op))
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)

    def fail(*args, **kw):
        raise AssertionError("a CUDA shard reached the earlier body")

    monkeypatch.setattr(th, "_launch", fake)
    monkeypatch.setattr(th, "_window_launch", fail)
    meta = torch.device("meta")
    mesh = Mesh((meta,) * 2)
    xs = [torch.empty(256, 16, device=meta) for _ in range(2)]
    ws = [torch.empty(256, 4, device=meta) for _ in range(2)]
    before = dict(LAUNCHES)
    th._ring_sum(xs, (1, -1, 5, -5), mesh)
    th._ring_sum(xs, (1, -1, 5, -5), mesh, ws=ws)
    th._ring_sum(xs, (1, -1), mesh, r=8)
    assert calls == ([((256, 16), False, "halo_banded_spmm")] * 2
                     + [((256, 16), True, "halo_banded_spmm")] * 2
                     + [((32, 128), False, "halo_banded_spmm_unit_packed")] * 2)
    assert LAUNCHES == before              # the ops themselves count nothing
    assert {op + tail for op in ("halo_banded_spmm", "halo_banded_spmm_unit_packed")
            for tail in ("", "_window")} <= set(LAUNCHES)
