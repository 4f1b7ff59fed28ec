"""K2 and K3 on the card run ``csrc/halo_stream.cu`` as a one-shard ring:
``ops/banded.wrap_tiles`` stages the circulant wrap as the ring's (pre,
post) tiles, as the TPU kernel stages it (K3: rotated by one lane group),
and the kernel sums pure row shifts.  Checked here on the CPU:

  * those tiles, fed to the halo op's plain version, give the circulant
    plain versions bit for bit, and the JAX package's ``banded_spmm_unit``
    and ``banded_spmm_unit_packed`` (run as its own tests run them on the
    CPU, in interpret mode) within rtol = atol = 1e-5 in float32; bfloat16
    within one bf16 ulp of JAX on the same values widened to float32 (the
    plain version sums in float32 and rounds once);
  * the kernel's slot walk (``_ring_walk`` of
    tests/test_torch_port_halo_stream.py) on those tiles equals the plain
    version;
  * the routing of tensors off the CPU by shape and address, each kernel's
    launch named by its op, and the launch geometry at the shapes
    ``chip_smoke.py`` and the card tests launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_halo_stream import _ring_walk

import gcn_maxcut_tpu.ops.pallas_banded as jb
from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.bench import microbench as micro
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.ops import halo_stream as hs
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES

GIANT = tgiant.circulant_offsets(8, 63, 0)
BENCH = micro.banded_offsets(8, 63)

# offsets that reach +Wp and -Wp (Wp = 8), and one side only (Wp = 16); the
# arrays have m = 2·Wp packed rows, so every row is within Wp of the wrap
OFFSETS = [(8, -8, 3, -1), (-16, 5, 11, 16)]
DTYPES = [torch.float32, torch.bfloat16]


def _tile_route_plain(x, offsets, r):
    """The route's arithmetic on the CPU: the wrap tiles of the [m, r·F]
    view, then the one-shard halo sum's plain version."""
    n, F = x.shape
    v = x.reshape(n // r, r * F)
    pre, post = tb.wrap_tiles(v, tb.padded_bandwidth(offsets), F)
    return th.halo_banded_spmm_plain(v, None, pre, post, offsets).reshape(n, F)


def _circulant_plain(x, offsets, r):
    if r == 1:
        return tb.banded_spmm_unit_plain(x, offsets)
    return tb.banded_spmm_unit_packed_plain(x, offsets, r)


def _jax_op(x, offsets, r):
    with pltpu.force_tpu_interpret_mode():
        if r == 1:
            return np.asarray(jb.banded_spmm_unit(jnp.asarray(x), offsets))
        return np.asarray(jb.banded_spmm_unit_packed(jnp.asarray(x), offsets, r))


def _within_one_bf16_ulp(got: torch.Tensor, ref32: torch.Tensor) -> None:
    _, exp = torch.frexp(ref32)
    ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0**-133),
                      torch.ldexp(torch.ones_like(ref32), exp - 8))
    assert bool(((got.float() - ref32).abs() <= ulp).all())


@pytest.mark.parametrize("offsets", OFFSETS, ids=["wp8", "wp16"])
@pytest.mark.parametrize("F", [3, 16])
@pytest.mark.parametrize("r", [1, 2, 8])
def test_wrap_tiles_give_the_circulant_sum(r, F, offsets):
    wp = tb.padded_bandwidth(offsets)
    n = r * 2 * wp                                   # m = 2·Wp
    rng = np.random.default_rng(100 * r + F)
    x = rng.normal(size=(n, F)).astype(np.float32)
    dy = rng.normal(size=(n, F)).astype(np.float32)
    neg = tuple(-o for o in offsets)
    # JAX's values and gradient (the same op with negated offsets)
    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(lambda z: (jb.banded_spmm_unit(z, offsets) if r == 1 else
                                      jb.banded_spmm_unit_packed(z, offsets, r)),
                           jnp.asarray(x))
        g_j = np.asarray(vjp(jnp.asarray(dy))[0])
    y_j = np.asarray(y_j)
    for dtype in DTYPES:
        xt, dyt = torch.tensor(x).to(dtype), torch.tensor(dy).to(dtype)
        y = _tile_route_plain(xt, offsets, r)
        g = _tile_route_plain(dyt, neg, r)
        assert y.dtype == dtype
        # bit for bit: both sum in float32 in offset order from zero and
        # round once
        assert torch.equal(y, _circulant_plain(xt, offsets, r))
        assert torch.equal(g, _circulant_plain(dyt, neg, r))
        if dtype == torch.float32:
            np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-5)
        else:
            # JAX on the same bf16 values widened to float32
            ref = _jax_op(xt.float().numpy(), offsets, r)
            ref_g = _jax_op(dyt.float().numpy(), neg, r)
            _within_one_bf16_ulp(y, torch.tensor(ref))
            _within_one_bf16_ulp(g, torch.tensor(ref_g))


def test_wrap_tiles_are_views_at_r1_and_rotated_when_packed():
    x = torch.arange(32 * 6, dtype=torch.float32).reshape(32, 6)
    pre, post = tb.wrap_tiles(x, 8, 6)                # r = 1: no copy
    assert pre.data_ptr() == x[24:].data_ptr() and post.data_ptr() == x.data_ptr()
    assert pre.shape == post.shape == (8, 6)
    pre, post = tb.wrap_tiles(x, 8, 2)                # r = 3, F = 2
    assert torch.equal(pre, torch.cat([x[24:, 4:], x[24:, :4]], dim=1))
    assert torch.equal(post, torch.cat([x[:8, 2:], x[:8, :2]], dim=1))


# (r, F, offsets, (chunk, strip, cols)): several strips and chunks, a
# partial last chunk, the shipped geometry where the rows are 16-byte pieces
WALKS = [
    (1, 16, (8, -8, 3, -1), (4, 8, 4)),
    (2, 3, (-16, 5, 11, 16), (4, 12, 4)),
    (8, 3, (8, -8, 3, -1), (4, 8, 8)),
    (8, 16, (8, -8, 3, -1), None),
    (1, 16, GIANT, None),
    (8, 16, GIANT, None),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r,F,offsets,geom", WALKS)
def test_ring_walk_on_the_wrap_tiles_equals_plain(r, F, offsets, geom, dtype):
    wp = tb.padded_bandwidth(offsets)
    m = max(2 * wp, 150)
    gen = torch.Generator().manual_seed(m + F)
    x = torch.randn(r * m, F, generator=gen).to(dtype)
    v = x.view(m, r * F)
    pre, post = tb.wrap_tiles(v, wp, F)
    if geom is None:
        g = hs.halo_stream_shape(m, r * F, wp, 0, x.element_size())
        geom = (g.chunk, g.strip, g.cols)
    got = _ring_walk(v, pre, post, offsets, None, *geom).view(r * m, F)
    assert torch.equal(got, _circulant_plain(x, offsets, r))


def _on_card(monkeypatch):
    """Record the launchers' calls, by kernel and op, in place of launches."""
    calls = []

    def fake(kernel):
        def launch(x, *args, op="banded_spmm", **kw):
            calls.append((kernel, tuple(x.shape), op))
            return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return launch

    monkeypatch.setattr(tb, "_circulant_launch", fake("halo_stream"))
    monkeypatch.setattr(tb, "_launch", fake("banded_window"))
    monkeypatch.setattr(tb, "_stream_launch", fake("banded_stream"))
    return calls


def test_ops_off_the_cpu_route_by_shape_and_address(monkeypatch):
    calls = _on_card(monkeypatch)
    meta = torch.device("meta")
    offs = (1, -1, 5, -5)
    before = dict(LAUNCHES)

    def unit(n, F, dtype=torch.float32, r=1, x=None):
        x = torch.empty(n, F, dtype=dtype, device=meta) if x is None else x
        x.requires_grad_(True)
        y = tb.banded_spmm_unit(x, offs) if r == 1 else tb.banded_spmm_unit_packed(x, offs, r)
        y.backward(torch.empty_like(y))                   # the adjoint: one more launch
        out = calls[-2:]
        del calls[:]
        return out

    k2, k3 = "banded_spmm_unit", "banded_spmm_unit_packed"
    # K2 at F = 16 and K3 (also at F = 3: 96-byte packed rows) reach the
    # strip launcher, forward and backward
    assert unit(4096, 16) == [("halo_stream", (4096, 16), k2)] * 2
    assert unit(4096, 16, torch.bfloat16) == [("halo_stream", (4096, 16), k2)] * 2
    assert unit(4096, 16, r=8) == [("halo_stream", (512, 128), k3)] * 2
    assert unit(4096, 16, torch.bfloat16, r=8) == [("halo_stream", (512, 128), k3)] * 2
    assert unit(4096, 3, r=8) == [("halo_stream", (512, 24), k3)] * 2
    # rows that are not 16-byte pieces reach only the earlier body: K2 at
    # F = 3 (12 bytes; 6 in bf16), K3 at r = 2, F = 3 (24 bytes)
    assert unit(4096, 3) == [("banded_window", (4096, 3), k2)] * 2
    assert unit(4096, 3, torch.bfloat16) == [("banded_window", (4096, 3), k2)] * 2
    assert unit(4096, 3, r=2) == [("banded_window", (2048, 6), k3)] * 2
    # a misaligned x (one float off): the earlier body; its gradient is fresh
    x = torch.empty(4096 * 16 + 1, device=meta)[1:].view(4096, 16)
    assert unit(4096, 16, x=x) == [("banded_window", (4096, 16), k2),
                                   ("halo_stream", (4096, 16), k2)]
    # K4 by the same rule: F = 16 on its ring, F = 3 on its earlier body
    w = torch.empty(4096, 4, device=meta)
    tb._weighted_raw(torch.empty(4096, 16, device=meta), w, offs)
    tb._weighted_raw(torch.empty(4096, 3, device=meta), w, offs)
    assert calls == [("banded_stream", (4096, 16), "banded_spmm"),
                     ("banded_window", (4096, 3), "banded_spmm")]
    # the routes count nothing: each launcher counts where its kernel
    # launches, under the op's name or the op's name + "_window"
    assert LAUNCHES == before
    assert {op + tail for op in ("banded_spmm_unit", "banded_spmm_unit_packed", "banded_spmm")
            for tail in ("", "_window")} <= set(LAUNCHES)


def test_the_launchers_take_only_cuda_tensors():
    # no launcher falls back to a plain version or to the CPU
    meta = torch.device("meta")
    for x in (torch.empty(64, 16, device=meta), torch.empty(64, 16)):
        with pytest.raises(ValueError, match="CUDA"):
            tb._circulant_launch(x, (1, -1), 16, op="banded_spmm_unit")
        with pytest.raises(ValueError, match="CUDA"):
            tb._launch(x, (1, -1), 16, op="banded_spmm_unit")
    with pytest.raises(ValueError, match="multiple"):
        tb.banded_spmm_unit_packed(torch.empty(100, 16, device=meta), (1, -1), 8)


# (n, F, r, offsets): chip_smoke.py's K2 and K3 rows (the giant trainers'
# offsets at 10,002,432 and 1,048,576 rows, bench --what banded's F = 128
# at both sizes) and its small cases, and the card tests' CASES
SHAPES = [
    (10_002_432, 16, 1, GIANT), (10_002_432, 3, 1, GIANT), (1_048_576, 16, 1, GIANT),
    (1_048_576, 3, 1, GIANT), (10_002_432, 16, 8, GIANT),
    (131_072, 128, 1, BENCH), (1_250_304, 128, 1, BENCH),
    (296, 3, 8, (1, -1, 7, -7)), (400, 20, 8, (2, -5, 6)), (1024, 16, 8, (63, -63, 1, -1)),
    (4096, 16, 8, (1, -1, 5, -5)), (8192, 4, 32, (2, -2, 7, -7, 63, -63)),
    (4096, 32, 8, (33, -33, 1, -1)), (8192, 16, 32, (9, -9, 2, -2)), (4096, 16, 8, (3, 11)),
]


@pytest.mark.parametrize("n,F,r,offsets", SHAPES)
def test_halo_stream_shape_at_the_circulant_shapes(n, F, r, offsets):
    for r_, elsize in ((1, 4), (1, 2), (r, 4), (r, 2)):
        m, L = n // r_, r_ * F
        wp = tb.padded_bandwidth(offsets)
        assert 2 * wp <= m
        if L * elsize % 16:
            with pytest.raises(ValueError, match="16-byte"):
                hs.halo_stream_shape(m, L, wp, 0, elsize)
            continue
        g = hs.halo_stream_shape(m, L, wp, 0, elsize)
        assert g.smem_bytes == hs.halo_stream_smem_bytes(g.window_rows, g.cols, elsize, 0)
        assert g.smem_bytes <= hs.SMEM_LIMIT
        assert g.window_rows == g.strip + 2 * wp and g.strip % g.chunk == 0
        strips, tiles = g.grid
        assert strips * g.strip >= m > (strips - 1) * g.strip
        assert tiles * g.cols >= L > (tiles - 1) * g.cols
        assert g.vec == 16 // elsize and g.cols % g.vec == 0


def test_halo_stream_shape_at_the_giant_trainers():
    assert tb.padded_bandwidth(GIANT) == 56
    # K3 at the packed giant trainer's 10,002,432 × 16 (r = 8): 1,250,304
    # rows of 128 values, two 64-column tiles, strips of two chunks
    g = hs.halo_stream_shape(1_250_304, 128, 56, 0, 2)
    assert (g.vec, g.cols, g.strip, g.window_rows, g.smem_bytes) == (8, 64, 128, 240, 30_720)
    assert g.grid == (9768, 2)
    assert hs.halo_stream_shape(1_250_304, 128, 56, 0, 4).smem_bytes == 61_440
    # K2 at the plain giant trainer's F = 16 float32: one 16-column tile,
    # four threads a row
    g = hs.halo_stream_shape(10_002_432, 16, 56, 0, 4)
    assert (g.vec, g.cols, g.window_rows) == (4, 16, g.strip + 112)
    assert g.grid == (-(-10_002_432 // g.strip), 1)
    # the halo module re-exports the binding, so its names stay
    assert th.halo_stream_shape is hs.halo_stream_shape and th._vec16 is hs._vec16
    assert th._stream_kernel is hs._stream_kernel and th.SMEM_LIMIT == tb.SMEM_LIMIT
