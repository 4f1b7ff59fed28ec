"""P1–P5a's redesigned kernels, checked here on the CPU: P3's ring
(``csrc/subblock_stream.cu``), the warp gathers of P4 (``panel_ell_gather``)
and P1/P2 (``window_warp_gather``, both in ``csrc/probe_kernels.cu``), and
P5a on K4's ring in its column-weight mode (``csrc/banded_stream.cu``).
Pure-Python walks of the rings' schedules and models of the gathers'
ballot walk are held against the plain versions bit for bit, the launch
geometries are checked at every shape ``chip_smoke.py`` and the card tests
launch, and the wrappers' routes (which shapes take the ring, the VEC = 1
gather or the earlier body) are checked without a card.
"""

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.experiments.panel_ell_probe import build_panel_tables
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES

UNROLL = 4          # csrc/probe_kernels.cu PROBE_GATHER_UNROLL


def _ring_walk(x, sidx, w, n, r0, wp, strip, cols):
    """``subblock_stream.cu``'s schedule in Python.  For each (strip, column
    tile) block: the prologue loads sub-block 0's slice, then each
    sub-block first loads the next one's r0 new rows into their ring slots
    (checked to hold no row that this or a later sub-block reads), turns
    its table's sender ids into ring slots (−1 outside its slice), then
    sums its rows in slot order (float32, separate multiply and add
    roundings) from the ring, reading only its own slice (checked: the
    slot holds that slice row).  Ring slot t mod R holds strip-local row t,
    R = 2·r0 + 2·Wp."""
    F, d = x.shape[1], sidx.shape[1]
    R, slice_rows = 2 * r0 + 2 * wp, r0 + 2 * wp
    out = torch.full((n, F), float("nan"))
    n_sub = n // r0
    for sub0 in range(0, n_sub, strip):
        subs = min(strip, n_sub - sub0)
        s0 = sub0 * r0
        need = subs * r0 + 2 * wp
        for c0 in range(0, F, cols):
            fc = min(cols, F - c0)
            ring = torch.full((R, fc), float("nan"))
            holds = torch.full((R,), -1, dtype=torch.long)
            loaded = []

            def load(t_lo, t_hi, j):
                for t in range(t_lo, min(t_hi, need)):
                    # sub-block j reads strip-local rows [j·r0, j·r0 + slice_rows)
                    assert holds[t % R] < j * r0
                    q = s0 - wp + t
                    assert -n <= q < 2 * n          # one wrap
                    ring[t % R] = x[q % n, c0:c0 + fc]
                    holds[t % R] = t
                    loaded.append(t)

            load(0, slice_rows, 0)
            base = 0
            for j in range(subs):
                if j + 1 < subs:                # in flight while sub-block j sums
                    load((j + 1) * r0 + 2 * wp, (j + 2) * r0 + 2 * wp, j)
                row0 = s0 + j * r0
                # the slot pass: each sender id becomes its ring slot, or −1
                l = sidx[row0:row0 + r0].long() - row0 + wp
                l = torch.where(l < 0, l + n, torch.where(l >= n, l - n, l))
                slots = torch.where(base + l >= R, base + l - R, base + l)
                slots = torch.where((l >= 0) & (l < slice_rows), slots, -1)
                acc = torch.zeros(r0, fc)
                for jj in range(d):
                    ok = slots[:, jj] >= 0
                    slot = slots[ok, jj]
                    assert torch.equal(holds[slot], j * r0 + l[ok, jj])
                    wk = w[row0:row0 + r0, jj:jj + 1][ok]
                    acc[ok] = acc[ok] + wk * ring[slot]
                out[row0:row0 + r0, c0:c0 + fc] = acc
                base = base + r0 - (R if base + r0 >= R else 0)
            assert sorted(loaded) == list(range(need))      # each row once
    assert not torch.isnan(out).any()
    return out


def _slice_table(n, d, r0, wp, seed, pad_frac=0.2):
    """Senders around each receiver's slice, up to 40 rows beyond it at
    both ends (skipped), across the wrap at row 0 and n − 1, and padding
    slots (sender n − 1, weight 0), as K1's tables have."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)[:, None]
    start = i // r0 * r0
    sidx = (start - wp + rng.integers(-40, r0 + 2 * wp + 40, size=(n, d))) % n
    w = (rng.random((n, d)) + 0.5).astype(np.float32)
    pad = rng.random((n, d)) < pad_frac
    sidx[pad], w[pad] = n - 1, 0.0
    return torch.from_numpy(sidx.astype(np.int32)), torch.from_numpy(w)


# (n, F, block, wp, d, (strip, cols) or None for the shipped geometry):
# several strips with a ragged last one and several column tiles, R0 = B =
# 240 at F = 3 (the VEC = 1 path on the card), a slice as wide as n, F = 16
# and a column tail (F = 20 in tiles of 8)
WALKS = [
    (1024, 16, 256, 64, 6, (3, 8)),
    (1200, 3, 240, 40, 6, (2, 3)),
    (1200, 3, 240, 40, 6, None),
    (2048, 16, 256, 128, 8, (16, 16)),
    (1152, 8, 128, 512, 4, (4, 8)),
    (768, 20, 256, 96, 5, (5, 8)),
    (2048, 16, 512, 256, 8, None),
]


@pytest.mark.parametrize("n,F,block,wp,d,geom", WALKS)
def test_subblock_ring_walk_equals_plain(n, F, block, wp, d, geom):
    r0 = tbell.sub_block_rows(block)
    sidx, w = _slice_table(n, d, r0, wp, seed=n + wp)
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(n, F)).astype(np.float32))
    if geom is None:
        g = tpk.subblock_stream_shape(n, F, r0, wp, d, 4 if F % 4 == 0 else 1)
        geom = (g.strip, g.cols)
    got = _ring_walk(x, sidx, w, n, r0, wp, *geom)
    ref = tpk.subblock_spmm_plain(x, sidx, w, n, block, wp)
    assert torch.equal(got, ref)
    # some slots lay outside their slice (unless it spans all n rows), and
    # some rows read across the wrap
    start = (torch.arange(n) // r0 * r0)[:, None]
    valid = (sidx.long() - start + wp) % n < r0 + 2 * wp
    assert bool(valid.all()) == (r0 + 2 * wp == n)
    assert bool(((sidx.long() - torch.arange(n)[:, None]).abs() > n // 2).any())


def _ballot_sum(xn, acc, cols, src, ws, mask):
    """``probe_ballot_sum`` in Python: the ballot's set lanes in ascending
    order (slot order), ``UNROLL`` at a time, each slot's row loaded (the
    ``UNROLL`` loads in flight together) and summed in float32 with
    separate multiply and add roundings.  Returns the sum and the loads."""
    loads = 0
    while mask:
        taken = []
        for _ in range(UNROLL):
            if mask:
                lane = (mask & -mask).bit_length() - 1
                taken.append(lane)
                mask &= mask - 1
        assert taken == sorted(taken)
        rows = [xn[src[lane], cols] for lane in taken]      # in flight together
        loads += len(taken)
        for lane, row in zip(taken, rows):
            acc = acc + ws[lane] * row
    return acc, loads


def _ballot_walk(x, idx, wgt, n, block, wp, w_p, vec):
    """``panel_ell_gather``'s walk in Python: a warp a row; for each chunk
    of 32·vec columns, 32 slots a pass, each lane turns its slot into a
    source row (one wrap) and weight if filled; the ballot walk sums them.
    Returns the sums and the number of row loads, which is the filled
    slots' count (per chunk)."""
    F, slots = x.shape[1], idx.shape[1]
    xn, idn, wn = x.numpy(), idx.numpy(), wgt.numpy()
    out = np.empty((n, F), np.float32)
    loads = 0
    for i in range(n):
        first = i // block * block - wp
        for c0 in range(0, F, 32 * vec):
            cols = slice(c0, min(F, c0 + 32 * vec))
            acc = np.zeros(cols.stop - c0, np.float32)
            for p0 in range(0, slots, 32):
                src, ws, mask = [0] * 32, [np.float32(0)] * 32, 0
                for lane in range(32):
                    s = p0 + lane
                    if s < slots and 0 <= idn[i, s] < tpk.PANEL:
                        q = first + s // w_p * tpk.PANEL + int(idn[i, s])
                        assert -n <= q < 2 * n
                        src[lane], ws[lane] = q + n if q < 0 else q - n if q >= n else q, wn[i, s]
                        mask |= 1 << lane
                acc, k = _ballot_sum(xn, acc, cols, src, ws, mask)
                loads += k
            out[i, cols] = acc
    return torch.from_numpy(out), loads


# (n, F, block, wp, w_p, vec): 48 slots (two 32-slot passes, the second
# half full), 36 and 24 slots, VEC = 1 with column chunks (F = 40 is two
# chunks of 32), F = 3, and a row wider than one float4 chunk (F = 136)
BALLOTS = [
    (1536, 16, 512, 512, 4, 4),
    (1536, 8, 512, 512, 3, 4),
    (1024, 16, 256, 256, 4, 4),
    (768, 40, 256, 64, 2, 1),
    (1536, 3, 384, 64, 3, 1),
    (512, 136, 128, 64, 2, 4),
]


@pytest.mark.parametrize("n,F,block,wp,w_p,vec", BALLOTS)
def test_panel_ballot_walk_equals_plain(n, F, block, wp, w_p, vec):
    rng = np.random.default_rng(n + F)
    i = np.repeat(np.arange(n), 8)
    s = (i + rng.integers(-wp + 1, wp, size=i.shape[0])) % n
    s[:7] = (i[:7] + n // 2) % n                 # a few edges escape the window
    wts = (rng.random(i.shape[0]) + 0.5).astype(np.float32)
    idx, wgt, _, _ = build_panel_tables(s.astype(np.int64), i.astype(np.int64), wts, n,
                                        block, wp, w_p)
    ii, wg = torch.from_numpy(idx), torch.from_numpy(wgt)
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    got, loads = _ballot_walk(x, ii, wg, n, block, wp, w_p, vec)
    assert torch.equal(got, tpk.panel_ell_spmm_plain(x, ii, wg, n, block, wp, w_p))
    # empty slots cost no load: one row load per filled slot and column chunk
    filled = int(((ii >= 0) & (ii < tpk.PANEL)).sum())
    assert loads == filled * -(-F // (32 * vec))
    assert 0 < filled < ii.numel()


def test_panel_gather_shape():
    # a warp a row, 8 rows a block; float4 lanes where F and the addresses
    # allow (the launch of both warp gathers, P4's and P1/P2's)
    assert tpk.warp_gather_shape(100_352, 128) == (4, 12_544)
    assert tpk.warp_gather_shape(100_352, 128, vec4=False) == (1, 12_544)
    assert tpk.warp_gather_shape(1536, 130) == (1, 192)
    assert tpk.warp_gather_shape(1001, 16) == (4, 126)
    assert tpk.warp_gather_shape(99_840, 128) == (4, 12_480)       # P1/P2's tables


# (n, F, r0, Wp, d, vec) of every P3 launch: chip_smoke.py's two probe
# configurations and its past-L2 row, and the card tests' tables
SHAPES = [
    (100_352, 128, 128, 256, 8, 4), (100_352, 128, 128, 512, 8, 4),
    (1_048_576, 128, 128, 256, 8, 4),
    (2048, 16, 128, 64, 6, 4), (2048, 16, 128, 64, 6, 1), (1200, 3, 240, 40, 6, 1),
    (4096, 128, 128, 512, 8, 4), (2048, 130, 128, 128, 5, 1),
]


@pytest.mark.parametrize("n,F,r0,wp,d,vec", SHAPES)
def test_subblock_stream_geometry(n, F, r0, wp, d, vec):
    g = tpk.subblock_stream_shape(n, F, r0, wp, d, vec)
    # the C launcher's own sum of the shared memory, within a block's limit
    tables = -(-r0 * d * 4 // 16) * 16
    assert g.smem_bytes == -(-g.ring_rows * g.cols * 4 // 16) * 16 + 6 * tables
    assert g.smem_bytes <= 232_448
    # the ring holds a sub-block's slice and the next sub-block's rows
    assert g.ring_rows == 2 * r0 + 2 * wp and r0 + 2 * wp <= n
    # a thread owns vec columns of one row; a block has whole warps, no
    # more than a sub-block's (row, column group)s
    assert g.vec == vec
    groups = g.cols // vec
    assert g.cols % vec == 0 and groups <= g.threads <= tpk.SUBBLOCK_THREADS
    assert g.threads % 32 == 0 and g.threads < r0 * groups + 32
    assert g.cols <= tpk.SUBBLOCK_COLS
    # the strips cover all n rows, the last one ragged or full, none empty
    strips, tiles = g.grid
    assert strips * g.strip * r0 >= n > (strips - 1) * g.strip * r0
    assert tiles * g.cols >= F > (tiles - 1) * g.cols
    # the blocks fit the SMs' shared memory, all in one wave
    assert g.blocks_per_sm >= 1 and g.blocks_per_sm * g.threads <= 2048
    assert g.blocks_per_sm * (g.smem_bytes + tpk.SM_BLOCK_RESERVED) <= tpk.SM_SMEM
    assert strips * tiles <= tpk.SM_COUNT * g.blocks_per_sm


def test_subblock_stream_geometry_at_the_probe_shapes():
    # Wp = 256: a 768-row ring of 64 columns (192 KiB) and six 4 KiB table
    # arrays, one block of 512 threads an SM; 12 sub-blocks a strip: 66
    # strips × 2 tiles = 132 blocks, x read (12·128 + 512)/(12·128) = 1.33
    # times, against 5 times by the earlier body
    g = tpk.subblock_stream_shape(100_352, 128, 128, 256, 8, 4)
    assert (g.cols, g.threads, g.strip, g.ring_rows) == (64, 512, 12, 768)
    assert (g.smem_bytes, g.blocks_per_sm, g.grid) == (221_184, 1, (66, 2))
    assert g.reads == pytest.approx(4 / 3)
    # Wp = 512: a 64-column ring of 1280 rows does not fit, so 32 columns
    # (160 KB): 33 strips of 24 sub-blocks × 4 tiles, against 9 reads before
    g = tpk.subblock_stream_shape(100_352, 128, 128, 512, 8, 4)
    assert (g.cols, g.threads, g.strip, g.smem_bytes) == (32, 512, 24, 188_416)
    assert g.grid == (33, 4) and g.reads == pytest.approx(4 / 3)
    # past the L2 (n = 1,048,576): strips of 125 sub-blocks, x read 1.03 times
    g = tpk.subblock_stream_shape(1_048_576, 128, 128, 256, 8, 4)
    assert g.grid == (66, 2) and g.strip == 125 and g.reads == pytest.approx(1.032)


def test_subblock_stream_geometry_rejects_what_does_not_fit():
    # the tile is halved until the ring fits, else the shape is refused
    g = tpk.subblock_stream_shape(65_536, 128, 128, 2048, 8, 4)
    assert g.cols < tpk.SUBBLOCK_COLS and g.smem_bytes <= tpk.SMEM_LIMIT
    assert tpk.subblock_stream_smem_bytes(g.ring_rows, 2 * g.cols, 128, 8) > tpk.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        tpk.subblock_stream_shape(128_000, 4, 128, 30_000, 8, 4)
    with pytest.raises(ValueError, match="bad geometry"):
        tpk.subblock_stream_shape(1000, 16, 128, 64, 8, 4)        # r0 does not divide n
    with pytest.raises(ValueError, match="bad geometry"):
        tpk.subblock_stream_shape(1024, 16, 128, 512, 8, 4)       # slice wider than n
    with pytest.raises(ValueError, match="vec"):
        tpk.subblock_stream_shape(1024, 6, 128, 64, 8, 4)


# ---- P1/P2: window_warp_gather ---------------------------------------------

def _window_walk(xpad, lidx, w, block, wp, vec):
    """``window_warp_gather``'s walk in Python: a warp a row; for each chunk
    of 32·vec columns, d slots in passes of 32, each lane keeps its slot if
    its window index lies in [0, B + 2·Wp) and turns it into an xpad row;
    the ballot walk sums them.  xpad is widened to float32 as the lanes
    widen bf16.  Returns the sums and the row loads."""
    n, F, d = lidx.shape[0], xpad.shape[1], lidx.shape[1]
    xn, ln, wn = xpad.float().numpy(), lidx.numpy(), w.numpy()
    win_rows = block + 2 * wp
    out = np.empty((n, F), np.float32)
    loads = 0
    for i in range(n):
        row0 = i // block * block
        for c0 in range(0, F, 32 * vec):
            cols = slice(c0, min(F, c0 + 32 * vec))
            acc = np.zeros(cols.stop - c0, np.float32)
            for p0 in range(0, d, 32):
                src, ws, mask = [0] * 32, [np.float32(0)] * 32, 0
                for lane in range(min(32, d - p0)):
                    l = int(ln[i, p0 + lane])
                    if 0 <= l < win_rows:
                        src[lane], ws[lane] = row0 + l, wn[i, p0 + lane]
                        mask |= 1 << lane
                acc, k = _ballot_sum(xn, acc, cols, src, ws, mask)
                loads += k
            out[i, cols] = acc
    return torch.from_numpy(out), loads


# (n, F, d, B, Wp, vec, dtype): d = 3, 8 and 16 (a pass of 32 slots not
# full), d = 40 (two passes), F % 4 != 0 (VEC = 1 in chunks of 32: F = 40
# is two), a row wider than one float4 chunk (F = 136), bf16 at both VECs
WINDOW_WALKS = [
    (512, 16, 8, 128, 64, 4, torch.float32),
    (512, 16, 8, 128, 64, 4, torch.bfloat16),
    (600, 20, 3, 200, 24, 4, torch.float32),
    (512, 40, 16, 256, 128, 1, torch.bfloat16),
    (384, 3, 16, 128, 32, 1, torch.float32),
    (256, 136, 40, 64, 16, 4, torch.float32),
]


@pytest.mark.parametrize("n,F,d,block,wp,vec,dtype", WINDOW_WALKS)
def test_window_ballot_walk_equals_plain(n, F, d, block, wp, vec, dtype):
    rng = np.random.default_rng(n + d)
    xpad = torch.from_numpy(rng.normal(size=(n + 2 * wp, F)).astype(np.float32)).to(dtype)
    # slots a few rows outside the window at both ends, which are skipped
    lidx = torch.from_numpy(rng.integers(-3, block + 2 * wp + 3, size=(n, d)).astype(np.int32))
    w = torch.from_numpy((rng.random((n, d)) + 0.5).astype(np.float32))
    got, loads = _window_walk(xpad, lidx, w, block, wp, vec)
    assert torch.equal(got, tpk.window_gather_plain(xpad, lidx, w, block, wp))
    # slots outside the window cost no load: one row load per in-window slot
    # and column chunk
    inside = int(((lidx >= 0) & (lidx < block + 2 * wp)).sum())
    assert loads == inside * -(-F // (32 * vec))
    assert 0 < inside < lidx.numel()


def test_window_walk_at_a_probe_table():
    # P1's own table at a small n (every slot in its window), bf16 x
    from gcn_maxcut_tpu_torch.experiments import gather_probe as gp

    nbr, lidx, n, wp = gp.block_table(127, 256, n=1024)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    xpad = gp.pad_rows(x, wp).to(torch.bfloat16)
    li = torch.from_numpy(lidx)
    w = torch.from_numpy((rng.random(lidx.shape) + 0.5).astype(np.float32))
    got, loads = _window_walk(xpad, li, w, 256, wp, 4)
    assert loads == lidx.size
    assert torch.equal(got, tpk.window_gather_plain(xpad, li, w, 256, wp))


# ---- P5a: K4's ring with column-major weights ------------------------------

def _cols_ring_walk(x, wc, offsets, strip, cols, chunk=tb.STREAM_CHUNK):
    """``banded_stream.cu``'s schedule in its column-weight mode, in Python.
    For each (strip, column tile) block: the prologue loads chunk 0's
    window and weights; each chunk first loads the next chunk's new rows
    into their ring slots (checked to hold no row this chunk reads) and the
    next chunk's weights, as D runs of ``rows`` floats at wc[k, r:], into
    the other [D, chunk] buffer: 16-byte pieces where n % 4 == 0 (checked:
    each piece whole and aligned), else single floats.  Then it sums its
    rows in offset order (float32, separate roundings), reading the
    weight at [k·chunk + i] and the ring slot of strip-local row
    i + Wp + o_k (checked to hold it).  Ring slot t mod R holds
    strip-local row t, R = 2·chunk + 2·Wp."""
    n, F = x.shape
    D = len(offsets)
    wp = tb.padded_bandwidth(offsets)
    R = 2 * chunk + 2 * wp
    wflat = wc.reshape(-1)
    out = torch.full((n, F), float("nan"))
    pieces16 = n % 4 == 0
    for s0 in range(0, n, strip):
        rows_here = min(strip, n - s0)
        need = rows_here + 2 * wp
        n_chunks = -(-rows_here // chunk)
        for c0 in range(0, F, cols):
            fc = min(cols, F - c0)
            ring = torch.full((R, fc), float("nan"))
            holds = torch.full((R,), -1, dtype=torch.long)
            wbuf = torch.full((2, D * chunk), float("nan"))
            loaded = []

            def load_rows(t_lo, t_hi, reader):
                for t in range(t_lo, min(t_hi, need)):
                    # chunk `reader` reads strip-local rows [reader·chunk, +chunk + 2·Wp)
                    assert holds[t % R] < reader * chunk
                    q = s0 - wp + t
                    assert -n <= q < 2 * n          # one wrap
                    ring[t % R] = x[q % n, c0:c0 + fc]
                    holds[t % R] = t
                    loaded.append(t)

            def load_weights(j):
                r = s0 + j * chunk
                rows = min(chunk, n - r)
                buf = wbuf[j & 1]
                buf.fill_(float("nan"))
                step = 4 if pieces16 else 1
                assert rows % step == 0
                for k in range(D):
                    for i in range(0, rows, step):
                        src = k * n + r + i
                        assert src % step == 0 and (k * chunk + i) % step == 0
                        buf[k * chunk + i:k * chunk + i + step] = wflat[src:src + step]

            load_rows(0, chunk + 2 * wp, 0)
            load_weights(0)
            base = 0
            for j in range(n_chunks):
                if j + 1 < n_chunks:            # in flight while chunk j sums
                    load_rows((j + 1) * chunk + 2 * wp, (j + 2) * chunk + 2 * wp, j)
                    load_weights(j + 1)
                r = s0 + j * chunk
                rows = min(chunk, n - r)
                acc = torch.zeros(rows, fc)
                wb = wbuf[j & 1]
                for k, o in enumerate(offsets):
                    i = torch.arange(rows)
                    slot = (base + wp + i + o) % R
                    assert torch.equal(holds[slot], j * chunk + wp + i + o)
                    acc = acc + wb[k * chunk + i][:, None] * ring[slot]
                out[r:r + rows, c0:c0 + fc] = acc
                base = (base + chunk) % R
            assert sorted(loaded) == list(range(need))      # each row once
    assert not torch.isnan(out).any()
    return out


# (n, F, offsets, (strip, cols) or None for stream_shape's): several strips
# with a ragged last one (n % strip != 0) and chunks ragged at its end,
# column tiles with a tail, n % 4 != 0 (4-byte weight copies), 2·Wp = n,
# and the shipped geometry
COLS_WALKS = [
    (1000, 8, (1, -1, 5, -5, 63, -63), (192, 4)),
    (1001, 12, (7, -7, 60, -60), (128, 8)),
    (128, 8, (64, -64, 3), (64, 8)),
    (1536, 16, (17, -17, 32, -32), None),
    (1030, 4, (5,), (256, 4)),
]


@pytest.mark.parametrize("n,F,offsets,geom", COLS_WALKS)
def test_cols_ring_walk_equals_plain(n, F, offsets, geom):
    rng = np.random.default_rng(n + F)
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    wc = torch.from_numpy((rng.random((len(offsets), n)) + 0.5).astype(np.float32))
    if geom is None:
        g = tb.stream_shape(n, F, tb.padded_bandwidth(offsets), len(offsets))
        geom = (g.strip, g.cols)
    got = _cols_ring_walk(x, wc, offsets, *geom)
    assert torch.equal(got, tpk.banded_spmm_cols_plain(x, wc, offsets))
    # K4's ring on the row-major weights computes the same, bit for bit
    assert torch.equal(got, tb.banded_spmm_plain(x, wc.t().contiguous(), offsets))


def test_cols_ring_geometry_is_k4s():
    # P5a runs in K4's geometry: the weight buffers hold the same bytes
    # ([D, chunk] against [chunk, D]); at the probe's shape a 1024-row strip
    # of 64-row chunks, 64-column tiles, x read (1024 + 128)/1024 = 1.125 times
    g = tb.stream_shape(131_072, 128, 64, 8)
    assert (g.chunk, g.strip, g.cols, g.grid) == (64, 1024, 64, (128, 2))
    assert g.smem_bytes == tb.stream_smem_bytes(g.ring_rows, g.cols, 8) <= tpk.SMEM_LIMIT
    assert (g.strip + 2 * g.wp) / g.strip == pytest.approx(1.125)


# ---- routes: which shapes take the ring, the VEC = 1 gather, the earlier body

def _misaligned_cpu(x):
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


def _off_the_cpu(monkeypatch):
    """Let CPU tensors through the wrappers' device checks, so that their
    routes can be read without a card."""
    monkeypatch.setattr(tpk, "_dispatch", lambda name, x: False)
    monkeypatch.setattr(tpk, "_check_cuda", lambda name, *t: None)


def _record(monkeypatch, module, name, calls):
    def fake(x, *args, **kw):
        calls.append(name)
        return torch.zeros(x.shape)

    monkeypatch.setattr(module, name, fake)


@pytest.mark.parametrize("F,misaligned,route", [
    (16, False, "ring"), (128, False, "ring"), (3, False, "earlier"),
    (130, False, "earlier"), (16, True, "earlier")])
def test_banded_spmm_cols_route(monkeypatch, F, misaligned, route):
    # K4's rule: rows of whole 16-byte pieces on an aligned x take the ring
    # in its column-weight mode, anything else the earlier body; each
    # counted under the kernel that ran
    _off_the_cpu(monkeypatch)
    calls = []
    monkeypatch.setattr(tb, "_stream_call",
                        lambda x, w, offsets, wp, cols=False: calls.append(("ring", cols))
                        or torch.zeros(x.shape))
    _record(monkeypatch, tpk, "_banded_cols_window_launch", calls)
    n, offsets = 256, (1, -1, 9)
    x = torch.zeros(n, F)
    x = _misaligned_cpu(x) if misaligned else x
    before = dict(LAUNCHES)
    tpk.banded_spmm_cols(x, torch.ones(len(offsets), n), offsets)
    if route == "ring":
        assert calls == [("ring", True)]
        assert LAUNCHES == {**before, "banded_spmm_cols": before["banded_spmm_cols"] + 1}
    else:
        assert calls == ["_banded_cols_window_launch"]
        assert LAUNCHES == before        # the earlier body counts its own launch


def test_window_gather_reaches_only_the_warp_gather(monkeypatch):
    # P1/P2 off the CPU run window_warp_gather at every shape, and no other
    # launcher
    _off_the_cpu(monkeypatch)
    calls = []
    _record(monkeypatch, tpk, "_window_warp_launch", calls)
    monkeypatch.setattr(tpk, "_fn", lambda *a, **kw: pytest.fail("the staging body ran"))
    n, block, wp = 512, 128, 16
    for F, dtype in ((16, torch.float32), (3, torch.float32), (8, torch.bfloat16)):
        xpad = torch.zeros(n + 2 * wp, F, dtype=dtype)
        lidx = torch.zeros(n, 4, dtype=torch.int32)
        before = dict(LAUNCHES)
        tpk.window_gather(xpad, lidx, torch.ones(n, 4), block, wp)
        assert LAUNCHES == {**before, "window_gather": before["window_gather"] + 1}
    assert calls == ["_window_warp_launch"] * 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_gather_vec_rule(dtype):
    # VEC = 4 needs F % 4 == 0 and every operand at a multiple of 4 of its
    # elements (16 bytes in float32, 8 in bfloat16); else VEC = 1
    x = torch.zeros(64, 16, dtype=dtype)
    out = torch.zeros(64, 16)
    assert tpk._aligned4(x, out)
    assert not tpk._aligned4(_misaligned_cpu(x), out)
    assert not tpk._aligned4(x, _misaligned_cpu(out))
    assert tpk._aligned4(x[4:], out[8:])
    assert tpk.warp_gather_shape(64, 16, vec4=tpk._aligned4(_misaligned_cpu(x), out))[0] == 1
    assert tpk.warp_gather_shape(64, 18, vec4=tpk._aligned4(x, out))[0] == 1
