"""Port parity: GCNSoftmax layer by layer, the STE ops, the cut loss and
the gradients against the JAX package, on the ELL and the dense paths.

Tolerance: 1e-4 relative on activations, loss and gradients (the
contract of tests/test_torch_parity.py); float32 sums are taken in other
orders by the two frameworks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.models.gcn as jgcn
import gcn_maxcut_tpu.ops.segment as jseg
import gcn_maxcut_tpu.ops.ste as jste
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.models.gcn as tgcn
import gcn_maxcut_tpu_torch.ops.segment as tseg
import gcn_maxcut_tpu_torch.ops.ste as tste
from gcn_maxcut_tpu_torch.convert import params_from_jax

# each package's objectives/__init__ re-exports a function named cut_loss
jcut = importlib.import_module("gcn_maxcut_tpu.objectives.cut_loss")
tcut = importlib.import_module("gcn_maxcut_tpu_torch.objectives.cut_loss")

RTOL, ATOL = 1e-4, 1e-5


def _graphs(n, seed, p=0.15, weighted=False):
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1).astype(np.float32)
    if weighted:
        a = a * rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
    a = a + a.T
    return jgraph.graph_from_dense(a), tgraph.graph_from_dense(a)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(a), b.detach().numpy(), rtol=rtol, atol=atol
    )


@jax.jit
def _forward_j(params, g, x, a):
    h1 = jgcn.gcn_conv_apply(params["conv1"], g, x, a_dense=a)
    h2 = jgcn.gcn_conv_apply(params["conv2"], g, jax.nn.relu(h1), a_dense=a)
    probs = jax.nn.softmax(h2, axis=-1)
    onehot = jste.ste_argmax_onehot(jste.pin_terminals(probs))
    return h1, h2, probs, onehot, jcut.compute_loss(g, onehot)


def _forward_t(params, g, x, a):
    h1 = tgcn.gcn_conv_apply(params["conv1"], g, x, a_dense=a)
    h2 = tgcn.gcn_conv_apply(params["conv2"], g, torch.relu(h1), a_dense=a)
    probs = torch.softmax(h2, dim=-1)
    onehot = tste.ste_argmax_onehot(tste.pin_terminals(probs))
    return h1, h2, probs, onehot, tcut.compute_loss(g, onehot)


@pytest.mark.parametrize("n,dense,seed", [(30, False, 0), (45, True, 1), (60, False, 2)])
def test_gcn_softmax_layers_loss_and_grads_match_jax(n, dense, seed):
    gj, gt = _graphs(n, seed)
    assert gt.ell_senders is not None
    params = jgcn.gcn_softmax_init(jax.random.PRNGKey(seed), 24, 12, 3)
    pt = params_from_jax(params, device="cpu")
    x = np.random.default_rng(seed + 10).normal(size=(gj.n_pad, 24)).astype(np.float32)
    aj = jgraph.dense_adjacency(gj, values="mask") if dense else None
    at = tgraph.dense_adjacency(gt, values="mask") if dense else None

    outs_j = _forward_j(params, gj, jnp.asarray(x), aj)
    xt = torch.tensor(x, requires_grad=True)
    for t in (pt["conv1"]["w"], pt["conv1"]["b"], pt["conv2"]["w"], pt["conv2"]["b"]):
        t.requires_grad_(True)
    outs_t = _forward_t(pt, gt, xt, at)
    for oj, ot in zip(outs_j, outs_t):
        _close(oj, ot)

    gp_j, gx_j = jax.jit(jax.grad(
        lambda p, x_: _forward_j(p, gj, x_, aj)[-1], argnums=(0, 1)
    ))(params, jnp.asarray(x))
    outs_t[-1].backward()
    for layer in ("conv1", "conv2"):
        for k in ("w", "b"):
            _close(gp_j[layer][k], pt[layer][k].grad)
    _close(gx_j, xt.grad)


def test_gcn_softmax_module_and_dropout():
    _, gt = _graphs(30, 5)
    gen = torch.Generator().manual_seed(0)
    model = tgcn.GCNSoftmax.init(16, 8, 3, gen, dropout=0.5)
    x = torch.randn(gt.n_pad, 16, generator=gen)
    model.eval()
    p_eval = model(gt, x)
    assert torch.allclose(p_eval, tgcn.gcn_softmax_apply(model.params(), gt, x))
    torch.testing.assert_close(p_eval.sum(-1), torch.ones(gt.n_pad))
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(gt, x)
    p_train = model(gt, x, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(p_train, p_eval)


def test_spmm_paths_sddmm_and_segment_sum_match_jax():
    gj, gt = _graphs(40, 7, weighted=True)
    x = np.random.default_rng(0).normal(size=(gj.n_pad, 5)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    _close(jseg.spmm(gj, xj), tseg.spmm(gt, xt))
    _close(jseg.spmm(gj, xj, gj.weights), tseg.spmm(gt, xt, gt.weights))
    w = np.random.default_rng(1).random(gj.e_pad).astype(np.float32)
    _close(jseg.spmm(gj, xj, jnp.asarray(w)), tseg.spmm(gt, xt, torch.tensor(w)))
    _close(jseg.sddmm(gj, xj, xj), tseg.sddmm(gt, xt, xt))
    _close(jseg.segment_sum_edges(gj, jnp.asarray(w)),
           tseg.segment_sum_edges(gt, torch.tensor(w)))
    s = jax.nn.softmax(xj[:, :3], axis=-1)
    _close(jcut.relaxed_cut_value(gj, s), tcut.relaxed_cut_value(gt, torch.tensor(np.asarray(s))))
    _close(jcut.compute_loss(gj, s, penalty=2.0),
           tcut.compute_loss(gt, torch.tensor(np.asarray(s)), penalty=2.0))
    asn = np.random.default_rng(2).integers(0, 3, size=(4, gj.n_pad))
    cuts_t = tcut.hard_cut_value(gt, torch.tensor(asn))
    for i in range(4):
        _close(jcut.hard_cut_value(gj, jnp.asarray(asn[i])), cuts_t[i])


@pytest.mark.parametrize("mode", ["mask", "weights"])
def test_ell_backward_on_asymmetric_graph_matches_dense_autograd(mode):
    # a directed graph must not take the symmetric-backward shortcut
    rng = np.random.default_rng(3)
    a = (np.triu(rng.random((24, 24)) < 0.3, 1) * rng.uniform(0.5, 2, (24, 24))).astype(np.float32)
    g = tgraph.graph_from_dense(a)
    assert not g.symmetric and g.ell_senders is not None
    dense = torch.tensor(a if mode == "weights" else (a != 0).astype(np.float32))
    x = torch.randn(g.n_pad, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    dy = torch.randn(g.n_pad, 4, generator=torch.Generator().manual_seed(1))
    (tseg.spmm_ell(g, x, mode) * dy).sum().backward()
    op = torch.zeros(g.n_pad, g.n_pad)
    op[:24, :24] = dense.T          # graph_from_dense: edge (i -> j) per a[i, j]
    x2 = x.detach().clone().requires_grad_(True)
    (op @ x2 * dy).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=RTOL, atol=ATOL)


def test_ste_ties_and_pinning_match_jax():
    h = np.array([[0.2, 0.5, 0.3], [0.4, 0.4, 0.2], [0.3, 0.3, 0.3],
                  [0.1, 0.45, 0.45], [0.6, 0.2, 0.2]], np.float32)
    ht = torch.tensor(h, requires_grad=True)
    out_t = tste.ste_argmax_onehot(tste.pin_terminals(ht))
    out_j = jste.ste_argmax_onehot(jste.pin_terminals(jnp.asarray(h)))
    np.testing.assert_array_equal(np.asarray(out_j), out_t.detach().numpy())
    np.testing.assert_array_equal(out_t.detach().numpy()[3], [0, 1, 0])
    (out_t * torch.arange(15.).view(5, 3)).sum().backward()
    torch.testing.assert_close(ht.grad, torch.arange(15.).view(5, 3))
