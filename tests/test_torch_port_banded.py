"""Port parity: the banded SpMM ops (K2, K3) and the giant trainers.

On the CPU the port's ops run their plain PyTorch versions; they are held
here against the JAX package's Pallas kernels run in interpret mode, at the
cases of tests/test_pallas_banded.py, values and gradients, rtol = atol =
1e-5 (float32 sums in other orders).  The CUDA kernel itself is held
against the plain version by tests/test_torch_port_cuda.py, which runs only
where there is a card (and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcn_maxcut_tpu.ops.pallas_banded as jb
from gcn_maxcut_tpu.bench import giant_demo as jgiant
from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.ops import banded as tb

CASES = [
    (4096, 16, 8, (1, -1, 5, -5)),
    (8192, 4, 32, (2, -2, 7, -7, 63, -63)),
    (4096, 32, 8, (33, -33, 1, -1)),
    (8192, 16, 32, (9, -9, 2, -2)),
    (4096, 16, 8, (3, 11)),            # one-sided, no ± symmetry
]


def test_pack_unpack_roundtrip_matches_jax():
    x = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    for r in (4, 8, 16):
        p = tb.pack_interleaved(torch.tensor(x), r)
        np.testing.assert_array_equal(
            p.numpy(), np.asarray(jb.pack_interleaved(jnp.asarray(x), r))
        )
        np.testing.assert_array_equal(tb.unpack_interleaved(p, r).numpy(), x)
    with pytest.raises(ValueError, match="multiple"):
        tb.pack_interleaved(torch.zeros(10, 2), 4)


def _grad_t(fn, x, dy):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    (y * torch.tensor(dy)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _grad_j(fn, x, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("n,F,r,offsets", CASES)
def test_plain_versions_match_jax_interpret(n, F, r, offsets):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, F)).astype(np.float32)
    dy = rng.normal(size=(n, F)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj, gj = _grad_j(lambda z: jb.banded_spmm_unit_packed(z, offsets, r), x, dy)
        yj1, gj1 = _grad_j(lambda z: jb.banded_spmm_unit(z, offsets), x, dy)
    yt, gt = _grad_t(lambda z: tb.banded_spmm_unit_packed(z, offsets, r), x, dy)
    yt1, gt1 = _grad_t(lambda z: tb.banded_spmm_unit(z, offsets), x, dy)
    for a, b in ((yj, yt), (gj, gt), (yj1, yt1), (gj1, gt1)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_plain_bf16_sums_in_float32_then_rounds():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(256, 6)).astype(np.float32)).to(torch.bfloat16)
    offsets = (1, -1, 4, -4, 9, -9)
    y = tb.banded_spmm_unit(x, offsets)
    assert y.dtype == torch.bfloat16
    ref = sum(torch.roll(x.float(), -o, dims=0) for o in offsets).to(torch.bfloat16)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_tile_shape_and_device_rules():
    assert tb.padded_bandwidth((3, -63)) == 64
    for L in (3, 16, 24, 128, 160):
        for wp, el in ((8, 2), (64, 2), (64, 4)):
            rows, cols = tb.tile_shape(L, wp, el)
            assert rows % 32 == 0 and cols == min(L, 128)
            assert (rows + 2 * wp) * cols * el <= 96 * 1024
    with pytest.raises(ValueError, match="too wide"):
        tb.tile_shape(128, 512, 4)
    # a tensor that is neither on the CPU nor on CUDA takes no plain path
    with pytest.raises(ValueError, match="CUDA"):
        tb.banded_spmm_unit(torch.empty(64, 4, device="meta"), (1, -1))


def _jax_packed_params(seed, n, r, emb=32, G=16):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "conv1": gcn_conv_init(k1, emb, G),
        "conv2": gcn_conv_init(k2, G, G),
        "embed": jax.random.normal(k3, (n // r, r * emb), jnp.float32) * 0.1,
    }


def test_packed_giant_trainer_matches_jax():
    kw = dict(n=4096, bandwidth=31, epochs=4, epochs_per_call=2, agg_dtype=None,
              mu_dtype=None, return_assignment=True)
    with pltpu.force_tpu_interpret_mode():
        rj = jgiant.train_banded_giant_packed(**kw)
    assert rj["epochs"] == 4
    params = params_from_jax(_jax_packed_params(0, 4096, 8), device="cpu")
    rt = tgiant.train_banded_giant_packed(params=params, device="cpu", **kw)
    assert rt["offsets"] == rj["offsets"]
    # the JAX trainer reports the two ends of its loss history
    np.testing.assert_allclose(
        [rt["initial_cut"], rt["final_cut"]], [rj["initial_cut"], rj["final_cut"]],
        rtol=1e-3,
    )
    assert rt["final_cut"] > rt["initial_cut"]
    agree = np.mean(rt["assignment"] == rj["assignment"])
    assert agree >= 0.999, agree


def test_packed_giant_trainer_bf16_defaults_improve_cut():
    r = tgiant.train_banded_giant_packed(n=4096, bandwidth=31, epochs=6, epochs_per_call=2,
                                         device="cpu")
    assert r["final_cut"] > r["initial_cut"]
    assert len(r["history"]) == 6


def test_plain_giant_trainer_matches_jax():
    with pltpu.force_tpu_interpret_mode():
        rj = jgiant.train_banded_giant(n=2048, bandwidth=31, epochs=4, epochs_per_call=2)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = params_from_jax({
        "conv1": gcn_conv_init(k1, 32, 16),
        "conv2": gcn_conv_init(k2, 16, 3),
        "embed": jax.random.normal(k3, (2048, 32), jnp.float32) * 0.1,
    }, device="cpu")
    rt = tgiant.train_banded_giant(n=2048, bandwidth=31, epochs=4, epochs_per_call=2,
                                   params=params, device="cpu")
    np.testing.assert_allclose(rt["initial_cut"], rj["initial_cut"], rtol=1e-3)
    np.testing.assert_allclose(rt["final_cut"], rj["final_cut"], rtol=1e-3)


WEIGHTED_CASES = [
    (4096, 16, (1, -1, 5, -5, 63, -63)),
    (2048, 3, (2, -7, 9)),                 # narrow class width, one-sided offsets
]


@pytest.mark.parametrize("n,F,offsets", WEIGHTED_CASES)
def test_weighted_plain_version_matches_jax_interpret(n, F, offsets):
    """K4's plain version against the JAX ``banded_spmm`` in interpret mode:
    values and both gradients (dx through the kernel with negated offsets
    and rolled weights, dw through PyTorch ops), rtol = atol = 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, F)).astype(np.float32)
    w = (rng.random((n, len(offsets))) + 0.5).astype(np.float32)
    dy = rng.normal(size=(n, F)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj, vjp = jax.vjp(lambda a, b: jb.banded_spmm(a, b, offsets), jnp.asarray(x),
                          jnp.asarray(w))
        dxj, dwj = vjp(jnp.asarray(dy))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    yt = tb.banded_spmm(xt, wt, offsets)
    yt.backward(torch.tensor(dy))
    for got, ref in ((yt.detach(), yj), (xt.grad, dxj), (wt.grad, dwj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        tb.banded_spmm_plain(torch.tensor(x), torch.tensor(w), offsets), yt.detach(),
        rtol=0, atol=0)


def test_weighted_rejects_what_jax_rejects():
    x = torch.zeros(64, 4)
    w = torch.ones(64, 2)
    with pytest.raises(ValueError, match="float32"):
        tb.banded_spmm(x.to(torch.bfloat16), w, (1, -1))
    with pytest.raises(ValueError, match="multiple"):
        tb.banded_spmm(x, w, (1, -1), block=48)
    with pytest.raises(ValueError, match="block"):
        tb.banded_spmm(x, w, (9, -1), block=8)
    with pytest.raises(ValueError, match="mode"):
        tb.banded_spmm(x, w, (1, -1), mode="fast")
    with pytest.raises(ValueError, match="CUDA"):
        tb.banded_spmm(torch.empty(64, 4, device="meta"), torch.empty(64, 2, device="meta"),
                       (1, -1))
    rows, cols = tb.tile_shape(128, 64, 4, row_bytes=4 * 8)
    assert rows % 32 == 0 and (rows + 128) * cols * 4 + 16 + rows * 32 <= 96 * 1024
    assert tb.tile_shape(16, 64, 4) == tb.tile_shape(16, 64, 4, row_bytes=0)
