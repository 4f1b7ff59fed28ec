"""The port's CUDA kernel against its plain PyTorch version, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest`` skips the JAX set-up of tests/conftest.py).  Without a
CUDA device every test here skips.

Tolerances: float32 rtol = atol = 1e-5 (the kernel sums in the plain
version's order, so it is usually exact); bfloat16 within one bf16 ulp of
the plain version, which sums in float32 and rounds once.
"""

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.ops import banded as tb

CASES = [
    (4096, 16, 8, (1, -1, 5, -5)),
    (8192, 4, 32, (2, -2, 7, -7, 63, -63)),
    (4096, 32, 8, (33, -33, 1, -1)),
    (8192, 16, 32, (9, -9, 2, -2)),
    (4096, 16, 8, (3, 11)),
    (296, 3, 8, (1, -1, 7, -7)),          # m = 37 rows: small, odd
    (400, 20, 8, (2, -5, 6)),             # L = 160: F does not divide the tile
    (1024, 16, 8, (63, -63, 1, -1)),      # m = 128 = 2·Wp: every tile wraps
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_kernel_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    if ref.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return
    ref32 = ref.float()
    _, exp = torch.frexp(ref32)
    ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0**-133),
                      torch.ldexp(torch.ones_like(ref32), exp - 8))
    assert bool(((got.float() - ref32).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["K2", "K3"])
def test_cuda_kernel_matches_plain(cuda_device, packed, dtype):
    rng = np.random.default_rng(2)
    for n, F, r, offsets in CASES:
        fn = ((lambda z: tb.banded_spmm_unit_packed(z, offsets, r)) if packed
              else (lambda z: tb.banded_spmm_unit(z, offsets)))
        x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(dtype)
        dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(dtype)
        before = dict(tb.LAUNCHES)
        xc = x.to(cuda_device).requires_grad_(True)
        yc = fn(xc)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        name = "banded_spmm_unit_packed" if packed else "banded_spmm_unit"
        assert tb.LAUNCHES[name] == before[name] + 2       # forward + backward
        xp = x.clone().requires_grad_(True)
        yp = fn(xp)
        yp.backward(dy)
        assert_kernel_close(yc.detach().cpu(), yp.detach())
        assert_kernel_close(xc.grad.cpu(), xp.grad)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(64, 4, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        tb.banded_spmm_unit(x, (40, -40))                  # 2·Wp > m
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tb.banded_spmm_unit(x.half(), (1, -1))


@pytest.mark.cuda
def test_cuda_packed_trainer_matches_cpu(cuda_device):
    kw = dict(n=4096, bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None,
              return_assignment=True)
    params = tgiant.packed_params(4096, seed=0, device="cpu")
    rc = tgiant.train_banded_giant_packed(params=params, device=cuda_device, **kw)
    rp = tgiant.train_banded_giant_packed(params=params, device="cpu", **kw)
    np.testing.assert_allclose(rc["history"], rp["history"], rtol=1e-3)
    assert np.mean(rc["assignment"] == rp["assignment"]) >= 0.999
