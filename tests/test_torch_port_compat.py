"""Port parity: the reference ``.pth`` migration (``train/torch_compat.py``)
and the ``convert`` command against the JAX package's.

The reference checkpoint is built as ``tests/test_torch_compat.py`` builds
it: a stepped torch Adam, the embedding under ``inputs`` and a pickled
config whose class is not importable at load time.  Both packages must
read it into bit-equal parameters, Adam moments and counts; each package
reads the other's export; and ``convert`` through either CLI writes equal
arrays both ways.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.cli as jcli
import gcn_maxcut_tpu.train as jtrain
import gcn_maxcut_tpu.utils.cache as jcache
import gcn_maxcut_tpu_torch.cli as tcli
import gcn_maxcut_tpu_torch.train.torch_compat as tcompat
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import setup_train_state
from tests.test_torch_compat import HID, N, _make_reference_checkpoint


@pytest.fixture
def ref_path(tmp_path):
    path = str(tmp_path / "final_refmodel.pth")
    _make_reference_checkpoint(path)
    return path


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _adam(opt_state):
    return opt_state[".inner_state"]["0"] if ".inner_state" in opt_state else opt_state["0"]


@pytest.mark.parametrize("feature_mode", ["adjacency", "embedding"])
def test_load_matches_jax(ref_path, feature_mode):
    cfg = dict(n_nodes=N, hidden_dim=HID, learning_rate=2e-3, feature_mode=feature_mode)
    jstate = jtrain.setup_train_state(jtrain.TrainingConfig(**cfg))
    tstate = setup_train_state(TrainingConfig(**cfg), device="cpu")
    pj, oj, mj = jtrain.load_torch_checkpoint(ref_path, optimizer=jstate.optimizer,
                                              params_template=jstate.params)
    pt, ot, mt = tcompat.load_torch_checkpoint(ref_path, optimizer=tstate,
                                               params_template=tstate.params())
    for conv in ("conv1", "conv2"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(_np(pt[conv][leaf]), np.asarray(pj[conv][leaf]))
    np.testing.assert_array_equal(_np(pt["embed"]), np.asarray(pj["embed"]))
    assert (mt["epoch"], mt["loss_history"]) == (mj["epoch"], mj["loss_history"])
    assert dataclasses.asdict(mt["config"]) == dataclasses.asdict(mj["config"])
    adam_j = oj.inner_state[0] if hasattr(oj, "inner_state") else oj[0]
    adam_t = _adam(ot)
    assert int(adam_t[".count"]) == int(adam_j.count) == 1
    for key, tree in ((".mu", adam_j.mu), (".nu", adam_j.nu)):
        for conv in ("conv1", "conv2"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(_np(adam_t[key][conv][leaf]),
                                              np.asarray(tree[conv][leaf]))
    # the embedding has no torch moment: its state stays as initialized
    if feature_mode == "embedding":
        assert not _np(adam_t[".mu"]["embed"]).any()
    else:
        assert "embed" not in adam_t[".mu"]
    # the grafted state loads into the trainer
    tstate.load(pt, ot)
    assert tstate.optimizer.count == 1


def test_moment_shape_mismatch_raises(ref_path):
    tstate = setup_train_state(TrainingConfig(n_nodes=N, hidden_dim=HID + 1), device="cpu")
    with pytest.raises(ValueError, match="template expects"):
        tcompat.load_torch_checkpoint(ref_path, optimizer=tstate,
                                      params_template=tstate.params())


def test_each_package_reads_the_others_export(tmp_path, ref_path):
    cfg = dict(n_nodes=N, hidden_dim=HID, learning_rate=2e-3)
    # the port's export, from a state carrying the reference's moments
    tstate = setup_train_state(TrainingConfig(**cfg), device="cpu")
    pt, ot, _ = tcompat.load_torch_checkpoint(ref_path, optimizer=tstate,
                                              params_template=tstate.params())
    out_t = str(tmp_path / "port.pth")
    tcompat.save_torch_checkpoint(out_t, pt, epoch=9, loss_history=[-2.0],
                                  config=TrainingConfig(**cfg), opt_state=ot)
    jstate = jtrain.setup_train_state(jtrain.TrainingConfig(**cfg))
    pj, oj, mj = jtrain.load_torch_checkpoint(out_t, optimizer=jstate.optimizer,
                                              params_template=jstate.params)
    np.testing.assert_array_equal(np.asarray(pj["conv1"]["w"]), _np(pt["conv1"]["w"]))
    np.testing.assert_array_equal(np.asarray(pj["embed"]), _np(pt["embed"]))
    assert (mj["epoch"], mj["loss_history"], mj["config"].n_nodes) == (9, [-2.0], N)
    np.testing.assert_array_equal(np.asarray(oj.inner_state[0].nu["conv2"]["w"]),
                                  _np(_adam(ot)[".nu"]["conv2"]["w"]))
    # the JAX export, read by the port
    out_j = str(tmp_path / "jax.pth")
    jtrain.save_torch_checkpoint(out_j, pj, epoch=3, loss_history=[-1.0],
                                 config=jtrain.TrainingConfig(**cfg), opt_state=oj)
    tstate2 = setup_train_state(TrainingConfig(**cfg), device="cpu")
    p2, o2, m2 = tcompat.load_torch_checkpoint(out_j, optimizer=tstate2,
                                               params_template=tstate2.params())
    np.testing.assert_array_equal(_np(p2["conv2"]["b"]), np.asarray(pj["conv2"]["b"]))
    np.testing.assert_array_equal(_np(_adam(o2)[".mu"]["conv1"]["w"]),
                                  np.asarray(oj.inner_state[0].mu["conv1"]["w"]))
    assert (m2["epoch"], m2["loss_history"]) == (3, [-1.0])
    # both exports have the same layout, tensor for tensor
    a, b = torch.load(out_t, weights_only=False), torch.load(out_j, weights_only=False)
    assert set(a) == set(b) and set(a["model"]) == set(b["model"])
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert set(a["optimizer"]["state"]) == set(b["optimizer"]["state"])


def _npz(path):
    with np.load(path) as d:
        arrays = {k: np.array(d[k]) for k in d.files if k != "_meta"}
        meta = json.loads(bytes(d["_meta"]).decode())
    return arrays, meta


def test_convert_both_ways_through_each_cli(tmp_path, ref_path, monkeypatch, capsys):
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        dst = str(tmp_path / f"{name}.npz")
        assert main(["convert", ref_path, dst]) == 0
        assert '"direction": "torch->npz"' in capsys.readouterr().out
        outs[name] = _npz(dst)
    (aj, mj), (at, mt) = outs["jax"], outs["port"]
    assert set(at) == set(aj)
    for k in aj:
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
        assert at[k].dtype == aj[k].dtype, k
    assert (mt["epoch"], mt["loss_history"]) == (mj["epoch"], mj["loss_history"]) == \
        (42, [-1.0, -5.0, -9.5])
    assert json.loads(mt["config"]) == json.loads(mj["config"])

    # npz -> pth from the same npz through each CLI
    pths = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        dst = str(tmp_path / f"back_{name}.pth")
        assert main(["convert", str(tmp_path / "jax.npz"), dst]) == 0
        assert '"direction": "npz->torch"' in capsys.readouterr().out
        pths[name] = torch.load(dst, weights_only=False)
    pj, pt = pths["jax"], pths["port"]
    for k in pj["model"]:
        assert torch.equal(pt["model"][k], pj["model"][k]), k
    assert torch.equal(pt["inputs"], pj["inputs"])
    assert set(pt["optimizer"]["state"]) == set(pj["optimizer"]["state"])
    for idx, s in pj["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(pt["optimizer"]["state"][idx][key], s[key]), (idx, key)
    assert (pt["epoch"], pt["loss_history"]) == (pj["epoch"], pj["loss_history"])
    assert vars(pt["config"]) == vars(pj["config"])
    # the round trip through the port alone: .npz -> .pth -> .npz, bit-equal
    assert tcli.main(["convert", str(tmp_path / "back_port.pth"),
                      str(tmp_path / "again.npz")]) == 0
    again, _ = _npz(str(tmp_path / "again.npz"))
    for k in at:
        np.testing.assert_array_equal(again[k], at[k], err_msg=k)


def test_resume_after_migration_runs(ref_path, monkeypatch):
    """The grafted state trains on: a short resume gives finite losses."""
    from gcn_maxcut_tpu_torch.examples import torch_migration

    monkeypatch.setattr(torch_migration, "RESUME_EPOCHS", 2)
    out = torch_migration.main(ref_path, device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    _, _, meta = tcompat.load_torch_checkpoint(out["exported"])
    assert meta["epoch"] == 44 and len(meta["loss_history"]) == 4
