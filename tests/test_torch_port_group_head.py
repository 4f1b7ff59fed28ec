"""The packed giant's head op and its route, on the CPU.

The card's op (``ops/group_head.py``, ``csrc/group_head.cu``) takes K3's
output z of the second layer to the straight-through one-hot S, the loss's
⟨S, A S⟩, and back to z's cotangent and b2's gradient.  Here: the plain op
against the trainer's composition (``group_softmax`` → ``pin_group_head`` →
``group_onehot`` → ``torch.dot``), values and gradients; the kernels'
arithmetic written out in torch float32 (the row sum folded by 8, 4, 2, 1,
the integer dot, the softmax adjoint p·(G − ⟨G, p⟩)) against the same
composition; the route rule and the CPU trainer's route, which keeps
calling ``giant_demo.group_onehot``.  The kernels themselves run in
``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.bench import giant_demo as gd
from gcn_maxcut_tpu_torch.ops import group_head as tgh
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm_unit_packed
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES

N, R, D, K = 4096, 8, 8, 3
INV_D = 1.0 / D
HEAD_KEYS = ("group_head", "cut_dot", "group_head_backward")


def _inputs(dtype: torch.dtype, seed: int = 0):
    """z [N, 16] in ``dtype`` with tied rows (two and three equal largest
    real lanes), b2 [16], and the circulant shifts of one job's graph."""
    rng = np.random.default_rng(seed)
    z = rng.normal(scale=8.0, size=(N, 16)).astype(np.float32)
    z[10:40, 1] = z[10:40, 0] = np.abs(z[10:40, :3]).max(axis=1) + 1.0
    z[40:60, :3] = 5.0
    b2 = np.zeros(16, np.float32)
    b2[:K] = 0.25                      # one bias on the real lanes: the ties survive it
    b2[K:] = rng.normal(size=16 - K)
    return (torch.tensor(z).to(dtype), torch.tensor(b2),
            gd.circulant_offsets(D, 31, seed))


def _composition(z, b2, offsets):
    """The trainer's head and loss on z, b2 (float32 activations)."""
    class_ok = (torch.arange(16) < K).float()
    term_onehot = torch.eye(16)[:K]
    h = z.to(torch.float32) * INV_D + b2
    onehot = gd.group_onehot(gd.pin_group_head(gd.group_softmax(h, class_ok), term_onehot),
                             class_ok)
    y = banded_spmm_unit_packed(onehot.to(z.dtype), offsets, R).to(torch.float32)
    return onehot, torch.dot(onehot.reshape(-1), y.reshape(-1))


def _grads(fn, z, b2):
    z = z.clone().requires_grad_(True)
    b2 = b2.clone().requires_grad_(True)
    same = fn(z, b2)
    loss = -(N * D // 2 - 0.5 * same)
    dz, db2 = torch.autograd.grad(loss, [z, b2])
    return same.detach(), dz, db2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_plain_op_equals_the_composition(dtype):
    z, b2, offsets = _inputs(dtype)
    got = _grads(lambda a, b: tgh.group_head_cut_plain(a, b, INV_D, K, offsets, R), z, b2)
    want = _grads(lambda a, b: _composition(a, b, offsets)[1], z, b2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _kernel_model(z, b2, offsets, g=0.5):
    """``csrc/group_head.cu``'s arithmetic in torch float32: (S, ⟨S, A S⟩,
    dz, db2) for the loss's cotangent g of ⟨S, A S⟩."""
    lane = torch.arange(16)
    real = lane < K
    h = z.to(torch.float32) * INV_D + b2
    m = torch.where(real, h, h + -1e9).amax(-1, keepdim=True)
    e = torch.where(real, torch.exp(h - m), torch.zeros(()))
    t = e.clone()
    for w in (8, 4, 2, 1):
        t[:, :w] = t[:, :w] + t[:, w:2 * w]
    p = torch.where(real, e / t[:, :1], torch.zeros(()))
    s = ((p >= p.amax(-1, keepdim=True)) & real).to(torch.float32)
    s[:K] = torch.eye(16)[:K]
    y = banded_spmm_unit_packed(s.to(z.dtype), offsets, R).to(torch.float32)
    at = banded_spmm_unit_packed(s.to(z.dtype), [-o for o in offsets], R).to(torch.float32)
    same = torch.tensor(float(int((s * y).to(torch.int64).sum())))
    G = g * y + g * at
    dot = torch.zeros(N)
    for c in range(K):
        dot = dot + G[:, c] * p[:, c]
    gh = torch.where(real, p * (G - dot[:, None]), torch.zeros(()))
    return s, same, (gh * INV_D).to(z.dtype), gh.sum(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernels_arithmetic_matches_the_composition(dtype):
    """The one-hot exactly (ties set several lanes, terminal rows their
    own), the integer dot to float32 rounding, the gradients to rounding:
    the softmax adjoint in another order than autograd's, and z's
    cotangent within one ulp of its dtype."""
    z, b2, offsets = _inputs(dtype)
    s, same, dz, db2 = _kernel_model(z, b2, offsets)
    onehot, want_same = _composition(z, b2, offsets)
    assert torch.equal(s, onehot.detach().round())
    assert torch.equal(onehot.to(dtype), s.to(dtype))
    assert s[10:40, :2].all() and s[40:60, :3].all()
    assert torch.equal(s[:K], torch.eye(16)[:K])
    assert abs(float(same) - float(want_same)) <= 1e-6 * abs(float(want_same))
    _, want_dz, want_db2 = _grads(lambda a, b: _composition(a, b, offsets)[1], z, b2)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    torch.testing.assert_close(dz.float(), want_dz.float(), rtol=ulp, atol=1e-6)
    torch.testing.assert_close(db2, want_db2, rtol=1e-5, atol=1e-5)
    assert torch.equal(db2[K:], torch.zeros(16 - K))


def test_the_route_rule():
    assert tgh.takes("cuda", torch.float32, 3)
    assert tgh.takes(torch.device("cuda:1"), torch.float32, 16)
    assert not tgh.takes("cpu", torch.float32, 3)
    assert not tgh.takes("cuda", torch.bfloat16, 3)
    assert not tgh.takes("cuda", torch.float32, 17)
    assert not tgh.takes("cuda", torch.float32, 0)


@pytest.mark.parametrize("act_dtype", [None, "bfloat16"], ids=["f32_act", "bf16_act"])
def test_the_cpu_trainer_keeps_the_composition(monkeypatch, act_dtype):
    """On the CPU, with float32 or bfloat16 activations, the packed trainer
    calls ``giant_demo.group_onehot`` once an epoch and launches nothing of
    the head's op."""
    calls = []
    real = gd.group_onehot

    def counted(pinned, class_ok):
        calls.append(pinned.shape)
        return real(pinned, class_ok)

    monkeypatch.setattr(gd, "group_onehot", counted)
    before = {k: LAUNCHES[k] for k in HEAD_KEYS}
    res = gd.train_banded_giant_packed(n=1024, bandwidth=15, epochs=4, epochs_per_call=2,
                                       act_dtype=act_dtype, device="cpu")
    assert len(calls) == res["epochs"] == 4
    assert {k: LAUNCHES[k] for k in HEAD_KEYS} == before


def test_the_kernels_take_only_card_tensors():
    z, b2, offsets = _inputs(torch.bfloat16)
    with pytest.raises(ValueError, match="on one card"):
        tgh.group_head_onehot(z, b2, INV_D, K)
    with pytest.raises(ValueError, match="on one card"):
        tgh.group_head_cut(z, b2, INV_D, K, offsets, R)


@pytest.mark.parametrize("n, sms, grid", [(1, 132, 1), (256, 132, 1), (257, 132, 2),
                                          (4096, 132, 16), (10_002_432, 132, 1056),
                                          (10_002_432, 114, 912)])
def test_the_grid_is_a_block_a_256_rows_at_most_8_an_sm(monkeypatch, n, sms, grid):
    monkeypatch.setattr(tgh, "_sms", lambda device: sms)
    assert tgh._grid(n, torch.device("cuda")) == grid


def _faults(dz, db2, z, b2, offsets):
    """The kernel model's gradients with one planted fault each: the softmax
    adjoint less its ⟨G, p⟩ term, inv_d applied twice, and block 0's
    partial of b2's gradient lost (a grid of 16 blocks of 256 rows)."""
    class_ok = (torch.arange(16) < K).float()
    h = z.to(torch.float32) * INV_D + b2
    s = _kernel_model(z, b2, offsets)[0].to(z.dtype)
    y = banded_spmm_unit_packed(s, offsets, R).float()
    at = banded_spmm_unit_packed(s, [-o for o in offsets], R).float()
    p = tgh.group_softmax(h, class_ok)
    block0 = (torch.arange(N) // 256) % 16 == 0
    return {"no_dot": ((p * 0.5 * (y + at) * INV_D).to(z.dtype), db2),
            "inv_d_twice": (dz * INV_D, db2),
            "block_lost": (dz, db2 - (dz.float() / INV_D)[block0].sum(0))}


@pytest.mark.parametrize("fault", ["none", "no_dot", "inv_d_twice", "block_lost"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_gradient_tolerance_passes_the_kernels_arithmetic_and_fails_a_wrong_one(dtype, fault):
    """``gradient_excess``, the tolerance the card's checks hold the op's
    gradients to, at most 1 on the kernels' arithmetic and above 1 on each
    planted fault."""
    z, b2, offsets = _inputs(dtype)
    _, _, dz, db2 = _kernel_model(z, b2, offsets)
    _, want_dz, want_db2 = _grads(lambda a, b: _composition(a, b, offsets)[1], z, b2)
    if fault == "none":
        assert max(tgh.gradient_excess(dz, db2, want_dz, want_db2, INV_D)) <= 1
    else:
        assert max(tgh.gradient_excess(*_faults(dz, db2, z, b2, offsets)[fault], want_dz,
                                       want_db2, INV_D)) > 1
