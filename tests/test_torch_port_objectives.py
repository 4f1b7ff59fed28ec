"""Port parity: the sampled-decode statistics and quantile loss, the balance
penalty, the (A, C) heuristic, the loss-variant zoo, the max-cut QUBO, the
STE threshold, the legacy QUBO model and the cosine schedule, against the
JAX package on the same inputs.

Values and gradients agree at rtol 1e-5 (atol 1e-6 for entries near
zero): the functions are float32 sums over the same edges, taken in other
orders by the two frameworks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.models.gcn as jgcn
import gcn_maxcut_tpu.ops.ste as jste
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.models.gcn as tgcn
import gcn_maxcut_tpu_torch.objectives.cut_loss as tcut
import gcn_maxcut_tpu_torch.objectives.qubo as tqubo
import gcn_maxcut_tpu_torch.objectives.variants as tvar
import gcn_maxcut_tpu_torch.ops.ste as tste
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.train.optim import cosine_decay_schedule

# the JAX package's objectives/__init__ re-exports functions under module names
jcut = importlib.import_module("gcn_maxcut_tpu.objectives.cut_loss")
jvar = importlib.import_module("gcn_maxcut_tpu.objectives.variants")
jqubo = importlib.import_module("gcn_maxcut_tpu.objectives.qubo")

RTOL, ATOL = 1e-5, 1e-6


def _graphs(n=40, seed=0, p=0.2):
    """A weighted random graph in both packages (n_pad > n: padded rows)."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1).astype(np.float32)
    a = a * rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
    a = a + a.T
    return jgraph.graph_from_dense(a, n_pad=n + 8), tgraph.graph_from_dense(a, n_pad=n + 8)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=RTOL, atol=ATOL)


def _probs(n_pad, seed, k=3):
    """Rows skewed toward the low classes, so the partition sizes sit well
    away from n / k and the balance penalty's gradient is not a float32
    cancellation."""
    alpha = np.arange(k, 0, -1, dtype=np.float64) ** 2 / 2
    return np.random.default_rng(seed).dirichlet(alpha, size=n_pad).astype(np.float32)


# (name, JAX function, port function): each maps (g, s) to an array
OBJECTIVES = [
    ("sampled_cut_stats", lambda g, s: jnp.stack(jcut.sampled_cut_stats(g, s)),
     lambda g, s: torch.stack(tcut.sampled_cut_stats(g, s))),
    ("quantile_cut_loss", lambda g, s: jcut.quantile_cut_loss(g, s, c=2.6, C=1.5),
     lambda g, s: tcut.quantile_cut_loss(g, s, c=2.6, C=1.5)),
    ("balance_penalty", jcut.balance_penalty, tcut.balance_penalty),
    ("ha_one_hot_penalty", jvar.ha_one_hot_penalty, tvar.ha_one_hot_penalty),
    ("intra_partition_weight", jvar.intra_partition_weight, tvar.intra_partition_weight),
    ("min_cut_intra_inter", lambda g, s: jvar.min_cut_intra_inter(g, s, alpha=0.7, beta=1.3),
     lambda g, s: tvar.min_cut_intra_inter(g, s, alpha=0.7, beta=1.3)),
    ("min_cut_loss_pairwise", jvar.min_cut_loss_pairwise, tvar.min_cut_loss_pairwise),
    ("per_partition_cut", jvar.per_partition_cut, tvar.per_partition_cut),
    ("weighted_cut_loss", lambda g, s: jvar.weighted_cut_loss(g, s, A=0.8, C=2.0),
     lambda g, s: tvar.weighted_cut_loss(g, s, A=0.8, C=2.0)),
    ("weighted_cut_loss A=0", lambda g, s: jvar.weighted_cut_loss(g, s, C=2.0),
     lambda g, s: tvar.weighted_cut_loss(g, s, C=2.0)),
]


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("name,fj,ft", OBJECTIVES, ids=[o[0] for o in OBJECTIVES])
def test_objective_value_and_gradient_match_jax(name, fj, ft, k):
    gj, gt = _graphs(seed=k)
    s = _probs(gj.n_pad, seed=10 + k, k=k)
    out_j = jax.jit(fj)(gj, jnp.asarray(s))
    st = torch.tensor(s, requires_grad=True)
    out_t = ft(gt, st)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    _close(out_j, out_t)
    # the gradient of a fixed random projection of the output
    c = np.random.default_rng(k).normal(size=np.shape(out_j)).astype(np.float32)
    grad_j = jax.jit(jax.grad(lambda x: jnp.sum(fj(gj, x) * c)))(jnp.asarray(s))
    (grad_t,) = torch.autograd.grad(torch.sum(out_t * torch.tensor(c)), st)
    _close(grad_j, grad_t)


def test_find_ac_parameters_match_jax():
    gj, gt = _graphs(seed=5)
    for a, b in zip(jcut.find_ac_parameters(gj), tcut.find_ac_parameters(gt)):
        assert float(a) == float(b)
    # padded rows carry no degree: the maximum is over real nodes only
    assert float(tcut.find_ac_parameters(gt)[0]) == float(gt.degrees.max()) + 1.0


@pytest.mark.parametrize("binary", [False, True], ids=["relaxed", "binary"])
def test_qubo_value_and_gradient_match_jax(binary):
    gj, gt = _graphs(seed=6)
    rng = np.random.default_rng(6)
    x = (rng.random(gj.n_pad) < 0.5 if binary else rng.random(gj.n_pad)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    _close(jqubo.maxcut_qubo_edges(gj, jnp.asarray(x)), tqubo.maxcut_qubo_edges(gt, xt))
    loss_t = tqubo.qubo_loss(gt, xt)
    _close(jqubo.qubo_loss(gj, jnp.asarray(x)), loss_t)
    _close(jax.grad(lambda v: jqubo.qubo_loss(gj, v))(jnp.asarray(x)),
           torch.autograd.grad(loss_t, xt)[0])
    if binary:   # −cut of the bitstring
        asn = torch.tensor(x.astype(np.int64))
        cut = float(tcut.hard_cut_value(gt, asn))
        assert float(loss_t.detach()) == pytest.approx(-cut, rel=1e-6)


def test_ste_threshold_matches_jax_at_ties():
    h = np.array([[0.5, 0.49999997, 0.50000006], [0.0, 1.0, 0.5]], np.float32)
    w = np.random.default_rng(0).normal(size=h.shape).astype(np.float32)
    for thr in (0.5, 0.25):
        out_j = jste.ste_threshold(jnp.asarray(h), thr)
        ht = torch.tensor(h, requires_grad=True)
        out_t = tste.ste_threshold(ht, thr)
        np.testing.assert_array_equal(np.asarray(out_j), out_t.detach().numpy())
        (grad_t,) = torch.autograd.grad(torch.sum(out_t * torch.tensor(w)), ht)
        grad_j = jax.grad(lambda x: jnp.sum(jste.ste_threshold(x, thr) * w))(jnp.asarray(h))
        np.testing.assert_array_equal(np.asarray(grad_j), grad_t.numpy())
        np.testing.assert_array_equal(grad_t.numpy(), w)          # identity gradient
    assert tste.ste_threshold(torch.tensor([0.5]))[0] == 1.0      # the tie goes to 1


@pytest.mark.parametrize("in_feats,hidden", [(24, 12), (8, 16)])
def test_gcn_dev_matches_jax(in_feats, hidden):
    gj, gt = _graphs(seed=7)
    params = jgcn.gcn_dev_init(jax.random.PRNGKey(3), in_feats, hidden, 1)
    pt = params_from_jax(params, device="cpu")
    x = np.random.default_rng(3).normal(size=(gj.n_pad, in_feats)).astype(np.float32)
    out_j = jax.jit(jgcn.gcn_dev_apply)(params, gj, jnp.asarray(x))
    leaves = [pt["conv1"]["w"], pt["conv1"]["b"], pt["conv2"]["w"], pt["conv2"]["b"]]
    for t in leaves:
        t.requires_grad_(True)
    out_t = tgcn.gcn_dev_apply(pt, gt, torch.tensor(x))
    assert out_t.shape == (gt.n_pad, 1)
    _close(out_j, out_t)
    grads_j = jax.jit(jax.grad(
        lambda p: jnp.sum(jgcn.gcn_dev_apply(p, gj, jnp.asarray(x)) ** 2)))(params)
    grads_t = torch.autograd.grad(torch.sum(out_t ** 2), leaves)
    for (layer, k), g in zip([("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b")],
                             grads_t):
        np.testing.assert_allclose(np.asarray(grads_j[layer][k]), g.numpy(),
                                   rtol=RTOL, atol=ATOL)
    gen = torch.Generator().manual_seed(0)
    fresh = tgcn.gcn_dev_init(in_feats, hidden, generator=gen)
    assert tgcn.count_params(fresh) == jgcn.count_params(params)


def test_count_params_of_the_recipe_model():
    params = jgcn.gcn_softmax_init(jax.random.PRNGKey(0), 1000, 500, 3)
    model = tgcn.GCNSoftmax.init(1000, 500, 3, torch.Generator().manual_seed(0))
    assert tgcn.count_params(model.params()) == jgcn.count_params(params) == 502_003


@pytest.mark.parametrize("T,alpha", [(12, 0.05), (1, 0.0), (300, 0.2)])
def test_cosine_schedule_matches_optax(T, alpha):
    ours = cosine_decay_schedule(3e-3, T, alpha)
    ref = optax.cosine_decay_schedule(3e-3, decay_steps=T, alpha=alpha)
    for t in list(range(min(T, 20) + 3)) + [T // 2, T, T + 7]:
        assert ours(t) == pytest.approx(float(ref(jnp.int32(t))), rel=1e-6)
    with pytest.raises(ValueError):
        cosine_decay_schedule(1e-3, 0)
