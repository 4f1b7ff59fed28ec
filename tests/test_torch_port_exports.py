"""The port's public names against the JAX package's.

Every public top-level name of a JAX module (``gcn_maxcut_tpu/<path>.py``)
has a counterpart under the same name in the port's module of that path,
or a row in ``gcn_maxcut_tpu_torch.JAX_NAMES`` (renamed, or not ported and
why); every subpackage's ``__all__`` is the JAX one's under that table.
The JAX side is read from its source (``ast``), so this file imports only
the port, and its imports are checked in a fresh interpreter.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

import gcn_maxcut_tpu_torch as port
from gcn_maxcut_tpu_torch.native import bindings

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "gcn_maxcut_tpu"
PORT_ROOT = ROOT / "gcn_maxcut_tpu_torch"
SUBPACKAGES = sorted(p.parent.name for p in JAX_ROOT.glob("*/__init__.py"))
# Exports of the port beyond the JAX package's (each subpackage's
# docstring says why).
PORT_ADDS = {
    "native": {"library", "metis_partition_native", "shard_assembly_native",
               "symmetry_check_native"},
    "bench": {"bench_sharded_conv", "scaling_sweep"},
    "parallel": {"GiantConfig", "Mesh", "Mesh2D", "decode_assignment", "make_hybrid_step",
                 "measure_epoch_time", "sharded_cut", "sharded_cut_edgeform",
                 "sharded_gcn_conv", "sharded_spmm_sym", "stack_sharded_graphs",
                 "train_giant_graph", "train_hybrid"},
}


def _defined(path: Path, with_imports: bool) -> set:
    """Top-level names a module binds: defs, classes, assignments (and,
    with ``with_imports``, the names it imports)."""
    names = set()
    body = list(ast.parse(path.read_text()).body)
    while body:
        node = body.pop()
        if isinstance(node, ast.If) and "__main__" in ast.unparse(node.test):
            continue                                     # a script's own names
        if isinstance(node, (ast.Try, ast.If)):          # a guarded import or default
            body += [*node.body, *node.orelse, *getattr(node, "finalbody", []),
                     *(s for h in getattr(node, "handlers", []) for s in h.body)]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _jax_all(pkg: str) -> list:
    for node in ast.parse((JAX_ROOT / pkg / "__init__.py").read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return [e.value for e in node.value.elts]
    raise AssertionError(f"gcn_maxcut_tpu.{pkg} has no __all__")


def _port_name(module: str, name: str) -> str | None:
    """The port's name for JAX's ``module.name`` (the table's first dotted
    part: ``GCNSoftmax.init`` is exported as ``GCNSoftmax``), None where
    it is not ported."""
    row = port.JAX_NAMES.get(f"{module}.{name}") or port.JAX_NAMES.get(name)
    if row is None:
        return name
    return None if row[0] is None else row[0].split(".")[0]


def _jax_modules():
    return sorted(str(p.relative_to(JAX_ROOT).with_suffix("")).replace("/", ".")
                  for p in JAX_ROOT.rglob("*.py") if p.name != "__init__.py")


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_counterpart_or_a_row(module):
    row = port.JAX_NAMES.get(module)
    if row is not None and row[0] is None:              # a module not ported, and why
        assert row[1]
        return
    ported = row[0] if row is not None else module
    path = PORT_ROOT / (ported.replace(".", "/") + ".py")
    assert path.exists(), f"no port of {module} at {path}"
    jax_names = {n for n in _defined(JAX_ROOT / (module.replace(".", "/") + ".py"), False)
                 if not n.startswith("_")}
    have = _defined(path, True)
    missing = sorted(n for n in jax_names
                     if _port_name(module, n) is not None and _port_name(module, n) not in have)
    assert not missing, f"{module}: no counterpart and no JAX_NAMES row for {missing}"


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_subpackage_exports_are_the_jax_ones(pkg):
    mod = importlib.import_module(f"gcn_maxcut_tpu_torch.{pkg}")
    expected = set()
    for name in _jax_all(pkg):
        defining = next(m for m in _jax_modules()
                        if m.startswith(f"{pkg}.") and name in _defined(
                            JAX_ROOT / (m.replace(".", "/") + ".py"), False))
        mapped = _port_name(defining, name)
        if mapped is not None:
            expected.add(mapped)
    assert set(mod.__all__) == expected | PORT_ADDS.get(pkg, set())
    assert len(mod.__all__) == len(set(mod.__all__))
    for name in mod.__all__:
        assert hasattr(mod, name), f"gcn_maxcut_tpu_torch.{pkg} does not bind {name}"


def test_the_table_names_what_exists():
    """Every row names a JAX module or a name one binds, and every port
    name it gives exists in the port's module of that path."""
    modules = set(_jax_modules())
    for key, (ported, why) in port.JAX_NAMES.items():
        assert why
        if key == "logger" or key in modules:
            continue
        module, name = key.rsplit(".", 1)
        assert module in modules and name in _defined(
            JAX_ROOT / (module.replace(".", "/") + ".py"), False), key
        if ported is not None:
            target = port.JAX_NAMES.get(module, (module,))[0]
            owner = importlib.import_module(f"gcn_maxcut_tpu_torch.{target}")
            obj = owner
            for part in ported.split("."):
                obj = getattr(obj, part)
    # the names this slice ported are no longer in the table
    for name in ("train.loop.make_epoch_fn", "parallel.giant_banded.make_halo_giant_step",
                 "parallel.giant_banded.make_packed_halo_step",
                 "bench.giant_demo.banded_gcn_conv", "native.bindings.build",
                 "models.gcn.GCNParams", "models.gcn.GCNSoftmaxParams"):
        assert name not in port.JAX_NAMES


def test_importing_the_port_loads_no_jax_library_or_kernel():
    """Every subpackage imported in a fresh interpreter: no JAX, nothing of
    the JAX package, no matplotlib (outside ``viz``), the native library
    not loaded and no kernel built."""
    code = f"""
import sys
for pkg in {[p for p in SUBPACKAGES if p != "viz"]!r}:
    __import__("gcn_maxcut_tpu_torch." + pkg)
from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.native import bindings
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gcn_maxcut_tpu", "matplotlib"))
print(bad, bindings.library.cache_info().currsize, build.load.cache_info().currsize)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "0", "0"], out.stdout


def test_native_build_compiles_and_reports(monkeypatch, tmp_path):
    monkeypatch.setattr(bindings, "BUILT", tmp_path / "native" / "libgraphtools.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert bindings.build() is False                    # no compiler: reported, no raise
    assert not bindings.BUILT.exists()
    monkeypatch.setenv("CXX", "g++")
    assert bindings.build(force=True) is True
    assert bindings.BUILT.stat().st_size > 0
    mtime = bindings.BUILT.stat().st_mtime_ns
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert bindings.build() is True                      # built already
    assert bindings.BUILT.stat().st_mtime_ns == mtime
    assert bindings.build(force=True) is False
