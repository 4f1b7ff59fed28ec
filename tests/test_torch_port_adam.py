"""Adam's step and its route (``ops/adam.py``, ``train/optim.py``), on the
CPU.

A CPU optimizer takes the plain step and launches nothing; the kernel route
refuses it, and the kernel's operand rules refuse what ``csrc/adam.cu`` does
not take.  The launch counters reset like the other kernels' and are
carried over a ``ChunkRunner``'s replays.  The
kernel itself runs only on the card, where ``tests/test_torch_port_cuda.py``
holds it to the plain step bit for bit.
"""

import pytest
import torch

from gcn_maxcut_tpu_torch.ops import adam as tadam
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.train import chunks
from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule

SHAPES = [(7, 5), (5,), (), (1000,)]


def _leaves(seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen) for s in SHAPES]


def _grads(step: int):
    gen = torch.Generator().manual_seed(100 + step)
    return [torch.randn(s, generator=gen) * 10.0 ** (step % 3 - 1) for s in SHAPES]


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["f32_mu", "bf16_mu"])
@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_cpu_leaves_take_the_plain_step_and_launch_nothing(mu_dtype, lr):
    rate = cosine_decay_schedule(3e-2, 6, 0.1) if lr == "cosine" else 3e-2
    got, ref = _leaves(), _leaves()
    opt, plain = Adam(got, rate, mu_dtype=mu_dtype), Adam(ref, rate, mu_dtype=mu_dtype)
    launched = dict(launches.LAUNCHES)
    for step in range(10):
        opt.step(_grads(step))
        tadam.step_plain(plain, _grads(step))
    assert launches.LAUNCHES == launched
    assert opt.count == plain.count == 10 and not opt._side
    for a, b in zip(got + opt.mu + opt.nu, ref + plain.mu + plain.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_launch_counters_reset_and_ride_the_chunk_runners_replays():
    # Adam's keys live in the one registry that the chunk runner carries
    # over its replays
    assert chunks.LAUNCHES is launches.LAUNCHES
    launches.LAUNCHES["adam_update"] += 3
    launches.LAUNCHES["adam_count"] += 1
    launches.reset()
    assert launches.LAUNCHES["adam_update"] == launches.LAUNCHES["adam_count"] == 0
    assert not any(launches.LAUNCHES.values())


def test_a_cpu_optimizer_keeps_no_per_card_state():
    leaves = _leaves()
    opt = Adam(leaves, 1e-2)
    assert opt._side == {} == tadam.side_state(leaves, opt._count, opt._tables)


def test_the_kernel_route_refuses_a_cpu_optimizer():
    opt = Adam(_leaves(), 1e-2)
    with pytest.raises(ValueError, match="made on a card"):
        tadam.step_kernel(opt, _grads(0))
    assert opt.count == 0


def _bad_leaf(case: str):
    p = torch.zeros(4, 6)
    g, mu, nu = torch.ones(4, 6), torch.zeros(4, 6), torch.zeros(4, 6)
    if case == "f64 parameter":
        p = p.double()
    elif case == "bf16 gradient":
        g = g.bfloat16()
    elif case == "f16 first moment":
        mu = mu.half()
    elif case == "bf16 second moment":
        nu = nu.bfloat16()
    elif case == "transposed gradient":
        g = torch.ones(6, 4).t()
    elif case == "strided first moment":
        mu = torch.zeros(4, 12)[:, ::2]
    elif case == "second moment of another shape":
        nu = torch.zeros(24)
    return p, g, mu, nu


@pytest.mark.parametrize("case", ["f64 parameter", "bf16 gradient", "f16 first moment",
                                  "bf16 second moment", "transposed gradient",
                                  "strided first moment", "second moment of another shape"])
def test_the_operand_rules_refuse_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="contiguous|shape"):
        tadam._check([_bad_leaf(case)], torch.device("cpu"))


def test_the_operand_rules_take_f32_and_bf16_first_moments_but_not_both():
    ok = [_bad_leaf("none"), (torch.zeros(3), torch.ones(3), torch.zeros(3), torch.zeros(3))]
    tadam._check(ok, torch.device("cpu"))
    bf16 = [(p, g, mu.bfloat16(), nu) for p, g, mu, nu in ok]
    tadam._check(bf16, torch.device("cpu"))
    with pytest.raises(ValueError, match="several dtypes"):
        tadam._check([ok[0], bf16[1]], torch.device("cpu"))
