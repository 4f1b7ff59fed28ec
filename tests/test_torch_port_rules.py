"""Rules of the port: no JAX in it, and the card unless the CPU is asked for."""

import ast
from pathlib import Path

import pytest
import torch

from gcn_maxcut_tpu_torch import device as tdevice
from gcn_maxcut_tpu_torch.bench.giant_demo import train_banded_giant_packed
from gcn_maxcut_tpu_torch.bench.locality import train_locality
from gcn_maxcut_tpu_torch.bench.microbench import bench_spmm, bench_spmm_banded
from gcn_maxcut_tpu_torch.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcn_maxcut_tpu")


def _port_files():
    files = sorted((ROOT / "gcn_maxcut_tpu_torch").rglob("*.py"))
    return [*files, ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    # entry points go through it: no silent CPU fallback
    with pytest.raises(RuntimeError):
        params_from_jax({"w": [[1.0]]})
    with pytest.raises(RuntimeError):
        train_banded_giant_packed(n=4096, epochs=1)
    for entry in (train_locality, bench_spmm, bench_spmm_banded):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(n=4096)
