"""Port parity: the node-sharded halo ops (K5, K6) and the halo giant trainers.

The JAX side runs as tests/test_pallas_halo.py and tests/test_giant_banded.py
run it: the Pallas halo kernels in interpret mode under ``jax.shard_map`` on
the virtual CPU mesh of tests/conftest.py.  The port runs on a CPU ring of
the same size (``make_mesh(devices=["cpu"] * D)``), where the ops take their
plain versions.  Inputs are drawn with numpy from a seed.  Tolerances: ops
rtol = atol = 1e-5 (float32 sums in other orders; bf16 at the JAX test's
scaled 3e-2), trainer cuts rtol = 1e-3 (the JAX plain trainer's embedding
gradient is the device count times the port's, which Adam hides up to eps).
The CUDA kernels are held against the plain versions by
tests/test_torch_port_cuda.py on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu.ops.pallas_banded import (
    banded_spmm_unit_xla,
    pack_interleaved,
    unpack_interleaved,
)
from gcn_maxcut_tpu.ops.pallas_halo import halo_banded_spmm, halo_banded_spmm_unit_packed
from gcn_maxcut_tpu.parallel import giant_banded as jgb
from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

OFFSETS = (1, -1, 5, -5, 13, -13)


def _cpu_ring(n_dev):
    return make_mesh(devices=["cpu"] * n_dev)


def _shards(a, n_dev):
    return [torch.tensor(s) for s in np.split(a, n_dev)]


def _jax_shard_map(fn, n_dev, n_in):
    mesh = JMesh(np.array(jax.devices()[:n_dev]), ("graph",))
    return jax.shard_map(fn, mesh=mesh, in_specs=(P("graph"),) * n_in,
                         out_specs=P("graph"), check_vma=False)


def _jax_k5(xg, wg, offsets, n_dev, block):
    n, F = xg.shape
    fn = _jax_shard_map(
        lambda x, w: halo_banded_spmm(x[0], w[0], offsets, "graph", block)[None], n_dev, 2)
    with pltpu.force_tpu_interpret_mode():
        out = fn(jnp.asarray(xg).reshape(n_dev, n // n_dev, F),
                 jnp.asarray(wg).reshape(n_dev, n // n_dev, -1))
    return np.asarray(out.astype(jnp.float32)).reshape(n, F)


@pytest.mark.parametrize("n_dev,block,n_shard,offsets", [
    (4, 16, 64, OFFSETS), (2, 32, 64, OFFSETS), (1, 16, 64, (2, -2)),
], ids=["D4", "D2", "D1-wrap"])
def test_k5_matches_jax_interpret(n_dev, block, n_shard, offsets):
    F = 128
    rng = np.random.default_rng(0)
    xg = rng.normal(size=(n_dev * n_shard, F)).astype(np.float32)
    wg = rng.random((n_dev * n_shard, len(offsets))).astype(np.float32)
    ref = _jax_k5(xg, wg, offsets, n_dev, block)
    ys = th.halo_banded_spmm(_shards(xg, n_dev), _shards(wg, n_dev), offsets,
                             _cpu_ring(n_dev), block)
    np.testing.assert_allclose(torch.cat(ys).numpy(), ref, rtol=1e-5, atol=1e-5)


def test_k5_bf16_streams_match_jax_interpret():
    n_dev, block, n_shard, F = 4, 16, 64, 128
    offsets = (1, -1, 5, -5)
    rng = np.random.default_rng(3)
    xg = rng.normal(size=(n_dev * n_shard, F)).astype(np.float32)
    xb = np.asarray(jnp.asarray(xg).astype(jnp.bfloat16).astype(jnp.float32))
    wg = np.ones((n_dev * n_shard, len(offsets)), np.float32)
    ref = _jax_k5(jnp.asarray(xg).astype(jnp.bfloat16), wg, offsets, n_dev, block)
    xs = [s.to(torch.bfloat16) for s in _shards(xb, n_dev)]
    ys = th.halo_banded_spmm(xs, _shards(wg, n_dev), offsets, _cpu_ring(n_dev), block)
    assert all(y.dtype == torch.bfloat16 for y in ys)
    got = torch.cat(ys).float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-2)


def _jax_k6(xg, offsets, r, n_dev, block, interpret=True):
    n, F = xg.shape
    pg = np.asarray(pack_interleaved(jnp.asarray(xg), r))
    fn = _jax_shard_map(
        lambda x: halo_banded_spmm_unit_packed(x[0], offsets, r, "graph", block)[None],
        n_dev, 1)
    x_sh = jnp.asarray(pg.reshape(n_dev, n // n_dev, F))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            out = fn(x_sh)
    else:
        out = fn(x_sh)
    return pg, np.asarray(out).reshape(n, F)


@pytest.mark.parametrize("n_dev,block,r,F,m_loc,offsets", [
    (4, 16, 4, 32, 64, OFFSETS),
    (2, 32, 4, 32, 64, OFFSETS),
    (8, 8, 4, 32, 64, OFFSETS),
    (4, 32, 4, 32, 32, (3, -3, 7, -7)),         # one block per device
    (4, None, 3, 8, 32, (2, -2, 9, -9)),        # L = 24: the JAX XLA fallback
], ids=["D4", "D2", "D8", "one-block", "L24"])
def test_k6_matches_jax(n_dev, block, r, F, m_loc, offsets):
    n = n_dev * m_loc * r
    rng = np.random.default_rng(1)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    pg, ref = _jax_k6(xg, offsets, r, n_dev, block, interpret=r * F % 128 == 0)
    ys = th.halo_banded_spmm_unit_packed(_shards(pg, n_dev), offsets, r, _cpu_ring(n_dev),
                                         block)
    np.testing.assert_allclose(torch.cat(ys).numpy(), ref, rtol=1e-5, atol=1e-5)
    # and in node order, the circulant operator
    node = np.asarray(unpack_interleaved(jnp.asarray(torch.cat(ys).numpy()), r))
    np.testing.assert_allclose(node, np.asarray(banded_spmm_unit_xla(jnp.asarray(xg), offsets)),
                               rtol=1e-5, atol=1e-5)


def test_k6_grad_is_jax_vjp():
    r, F, m_loc, n_dev = 4, 32, 32, 4
    offsets = (1, -1, 6, -6)
    n = n_dev * m_loc * r
    rng = np.random.default_rng(3)
    pg = np.asarray(pack_interleaved(jnp.asarray(rng.normal(size=(n, F)).astype(np.float32)), r))
    ct = rng.normal(size=(n, F)).astype(np.float32)

    def pull(x_sh, ct_sh):
        _, vjp_fn = jax.vjp(
            lambda x: halo_banded_spmm_unit_packed(x[0], offsets, r, "graph", 16)[None], x_sh)
        return vjp_fn(ct_sh)[0]

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_jax_shard_map(pull, n_dev, 2)(
            jnp.asarray(pg.reshape(n_dev, -1, F)), jnp.asarray(ct.reshape(n_dev, -1, F))))
    xs = [s.requires_grad_(True) for s in _shards(pg, n_dev)]
    ys = th.halo_banded_spmm_unit_packed(xs, offsets, r, _cpu_ring(n_dev), 16)
    torch.autograd.backward(ys, _shards(ct, n_dev))
    got = torch.cat([x.grad for x in xs]).numpy()
    np.testing.assert_allclose(got, ref.reshape(n, F), rtol=1e-5, atol=1e-5)


def test_k5_unit_grad_is_two_at_a_x():
    n_dev, n_shard, F, block = 4, 64, 16, 16
    rng = np.random.default_rng(4)
    xg = rng.normal(size=(n_dev * n_shard, F)).astype(np.float32)
    xs = [s.requires_grad_(True) for s in _shards(xg, n_dev)]
    ys = th.halo_banded_spmm_unit(xs, OFFSETS, _cpu_ring(n_dev), block)
    sum((y * y).sum() for y in ys).backward()
    ax = banded_spmm_unit_xla(jnp.asarray(xg), OFFSETS)
    ref = 2 * np.asarray(banded_spmm_unit_xla(ax, tuple(-o for o in OFFSETS)))
    got = torch.cat([x.grad for x in xs]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_exchange_at_one_shard_is_the_circulant_wrap():
    r, F, n = 8, 16, 1024
    offsets = (63, -63, 1, -1)
    x = torch.tensor(np.random.default_rng(5).normal(size=(n, F)).astype(np.float32))
    mesh = _cpu_ring(1)
    p = x.view(n // r, r * F)
    ((pre, post),) = th.halo_exchange([p], 64, mesh, lane_group=F)
    torch.testing.assert_close(pre, torch.roll(p[-64:], F, dims=1), rtol=0, atol=0)
    torch.testing.assert_close(post, torch.roll(p[:64], -F, dims=1), rtol=0, atol=0)
    (y,) = th.halo_banded_spmm_unit_packed([x], offsets, r, mesh)
    torch.testing.assert_close(y, tb.banded_spmm_unit_packed(x, offsets, r), rtol=0, atol=0)


def test_ops_reject_what_jax_rejects():
    mesh = _cpu_ring(2)
    xs = [torch.zeros(60, 8), torch.zeros(60, 8)]
    ws = [torch.ones(60, 2), torch.ones(60, 2)]
    with pytest.raises(ValueError, match="multiple"):
        th.halo_banded_spmm(xs, ws, (1, -1), mesh, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        th.halo_banded_spmm_unit([torch.zeros(60, 8)] * 2, (1, -1), mesh, 12)
    with pytest.raises(ValueError, match="block"):
        th.halo_banded_spmm_unit([torch.zeros(64, 8)] * 2, (9, -9), mesh, 8)
    with pytest.raises(ValueError, match="multiple of r"):
        th.halo_banded_spmm_unit_packed([torch.zeros(60, 8)] * 2, (1, -1), 8, mesh)
    with pytest.raises(ValueError, match="packed"):
        th.halo_banded_spmm_unit_packed([torch.zeros(64, 8)] * 2, (9, -9), 8, mesh)
    with pytest.raises(ValueError, match="shards for a mesh"):
        th.halo_banded_spmm_unit([torch.zeros(64, 8)], (1, -1), mesh, 16)
    with pytest.raises(ValueError, match="forward only"):
        th.halo_banded_spmm([torch.zeros(64, 8, requires_grad=True)] * 2,
                            [torch.ones(64, 2)] * 2, (1, -1), mesh, 16)


def _jax_init(seed, shapes, embed_shape):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "conv1": gcn_conv_init(k1, *shapes[0]),
        "conv2": gcn_conv_init(k2, *shapes[1]),
        "embed": jax.random.normal(k3, embed_shape, jnp.float32) * 0.1,
    }


def test_plain_halo_trainer_matches_jax():
    n_dev, n_shard = 4, 128
    kw = dict(d=4, dim_embedding=16, hidden_dim=16, epochs=10, bandwidth=15, block=64,
              learning_rate=5e-3)
    jmesh = jgb.make_mesh(("graph",), devices=jax.devices()[:n_dev])
    with pltpu.force_tpu_interpret_mode():
        rj = jgb.train_halo_giant(n_shard, jgb.HaloGiantConfig(epochs_per_call=10, **kw), jmesh)
    params = params_from_jax(
        _jax_init(0, [(16, 16), (16, 3)], (n_dev * n_shard, 16)), device="cpu")
    rt = tgb.train_halo_giant(n_shard, tgb.HaloGiantConfig(**kw), _cpu_ring(n_dev),
                              params=params, return_assignment=True)
    assert rt["n"] == rj["n"] == 512 and rt["num_devices"] == 4
    np.testing.assert_allclose([rt["initial_cut"], rt["final_cut"]],
                               [rj["initial_cut"], rj["final_cut"]], rtol=1e-3)
    assert rt["final_cut"] > rt["initial_cut"]
    assert rt["assignment"].shape == (512,) and list(rt["assignment"][:3]) == [0, 1, 2]


def test_packed_halo_trainer_matches_jax():
    # f32 streams and first moment: with a bf16 first moment the last cut
    # moves by a few edges of 2048 between the packages (and by more between
    # the JAX package's own sharded and single-chip trainers)
    n, n_dev = 1024, 4
    kw = dict(d=4, dim_embedding=32, learning_rate=5e-3, epochs=10, bandwidth=15, r=8,
              agg_dtype=None, mu_dtype=None)
    jmesh = jgb.make_mesh(("graph",), devices=jax.devices()[:n_dev])
    with pltpu.force_tpu_interpret_mode():
        rj = jgb.train_halo_giant_packed(
            n // n_dev, jgb.PackedHaloGiantConfig(epochs_per_call=10, **kw), jmesh)
    params = params_from_jax(_jax_init(0, [(32, 16), (16, 16)], (n // 8, 8 * 32)),
                             device="cpu")
    rt = tgb.train_halo_giant_packed(n // n_dev, tgb.PackedHaloGiantConfig(**kw),
                                     _cpu_ring(n_dev), params=params)
    assert rt["layout"] == rj["layout"] == "packed"
    np.testing.assert_allclose([rt["initial_cut"], rt["final_cut"]],
                               [rj["initial_cut"], rj["final_cut"]], rtol=1e-3)


def test_packed_halo_trainer_matches_single_chip_trainer():
    """Sharding is numerics only: 4 shards and the single-chip trainer from
    the same parameters give the same history (f32 streams)."""
    n = 1024
    kw = dict(d=4, bandwidth=15, epochs=10, epochs_per_call=5, agg_dtype=None, mu_dtype=None,
              learning_rate=5e-3)
    p0 = tgiant.packed_params(n, seed=0, device="cpu")
    single = tgiant.train_banded_giant_packed(n=n, params=p0, device="cpu",
                                              return_assignment=True, **kw)
    multi = tgb.train_halo_giant_packed(n // 4, tgb.PackedHaloGiantConfig(**kw), _cpu_ring(4),
                                        params=p0, return_assignment=True)
    np.testing.assert_allclose(multi["history"], single["history"], rtol=1e-5)
    np.testing.assert_array_equal(multi["assignment"], single["assignment"])
    assert multi["offsets"] == single["offsets"]


def test_plain_halo_trainer_quality_bound():
    """As tests/test_giant_banded.py's bound: n = 512, d = 4, 40 epochs at
    lr 1e-2 cut at least 90% of the edges."""
    cfg = tgb.HaloGiantConfig(d=4, dim_embedding=16, hidden_dim=16, epochs=40,
                              bandwidth=15, block=64, learning_rate=1e-2)
    res = tgb.train_halo_giant(128, cfg, _cpu_ring(4))
    assert res["cut_fraction"] >= 0.90, res["cut_fraction"]
    assert len(res["history"]) == 40
