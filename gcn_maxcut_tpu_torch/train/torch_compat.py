"""Two-way migration between the reference's PyTorch checkpoints and the
port's trainer.

Port of ``gcn_maxcut_tpu/train/torch_compat.py``.  The reference saves
``torch.save`` dicts ``{'epoch', 'model', 'optimizer', 'loss_history',
'inputs', 'config'}`` (``Training/TrainingNeural.py:451-458,625-633``):
``model`` is the ``GCNSoftmax`` state_dict, whose DGL ``GraphConv``
weights ``convN.weight`` [in, out] and ``convN.bias`` [out] are the port's
``params["convN"]["w"/"b"]``; ``inputs`` is the embedding table; and
``optimizer`` is torch Adam's state (``step``, ``exp_avg``, ``exp_avg_sq``
per parameter, in the order of ``chain(net, embed)``).

``load_torch_checkpoint`` turns that into the port's ``(params,
opt_state, meta)``, so a reference user resumes a half-trained model on
the card with the same Adam moments; ``save_torch_checkpoint`` writes the
reference's layout back, the config as a ``SimpleNamespace`` so that the
reference's ``checkpoint['config'].field`` works without this package.

The reference pickles its ``TrainingConfig`` instance, whose class is not
importable here; a permissive unpickler maps any class it cannot import
onto an attribute bag, and ``config_from_torch`` reads the known fields
onto the port's ``TrainingConfig``.  Unpickling runs code: load trusted
files only.

Differences from JAX: the port's optimizer state is the JAX optax layout
as nested dicts of tensors (``train.loop.TrainState.opt_state()``, what
``train/checkpoint.py`` saves), so ``optimizer`` here is the port's
``TrainState`` (whose ``opt_state()`` is the freshly initialized state
optax's ``optimizer.init`` gives in JAX) and ``params_template`` is its
``params()``.  Tensors come back on the CPU.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import pickle
import types
from typing import Any, Dict, List, Optional, Tuple

import torch

from gcn_maxcut_tpu_torch.train.config import TrainingConfig

logger = logging.getLogger(__name__)

# the reference's parameter order, chain(net, embed)
# (``setup_model_and_optimizer``, TrainingNeural.py:336-337)
_PARAM_ORDER = [
    ("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b"),
    ("embed", None),
]
_CONFIG_FIELDS = (
    "n_nodes", "dim_embedding", "hidden_dim", "dropout", "number_classes",
    "learning_rate", "number_epochs", "tolerance", "patience",
    "prob_threshold", "A", "C", "penalty", "save_directory", "save_frequency",
)


class _ConfigStub:
    """Attribute bag standing in for any unimportable pickled class."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and state and isinstance(state[0], dict):
            self.__dict__.update(state[0])


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            logger.info("stubbing unimportable pickled class %s.%s", module, name)
            return type(name, (_ConfigStub,), {})


class _PickleShim(types.ModuleType):
    """``pickle_module`` for ``torch.load`` that uses the permissive
    unpickler, forwarding ``torch.load``'s encoding (older ``.pth`` files
    are latin1-encoded)."""

    Unpickler = _PermissiveUnpickler
    UnpicklingError = pickle.UnpicklingError

    @staticmethod
    def load(f, **kwargs):
        enc = {"encoding": kwargs["encoding"]} if "encoding" in kwargs else {}
        return _PermissiveUnpickler(f, **enc).load()

    @staticmethod
    def loads(s, **kwargs):
        enc = {"encoding": kwargs["encoding"]} if "encoding" in kwargs else {}
        return _PermissiveUnpickler(io.BytesIO(s), **enc).load()


_pickle_shim = _PickleShim("gcn_maxcut_tpu_torch._torch_pickle_shim")


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t.detach() if hasattr(t, "detach") else t).cpu()


def config_from_torch(obj: Any) -> TrainingConfig:
    """The reference's config (an object or a dict) as the port's
    ``TrainingConfig``; fields it lacks keep their defaults."""
    if obj is None:
        return TrainingConfig()
    get = obj.get if isinstance(obj, dict) else (lambda k, d=None: getattr(obj, k, d))
    return TrainingConfig(**{f: get(f) for f in _CONFIG_FIELDS if get(f) is not None})


def load_torch_checkpoint(
    path: str,
    *,
    optimizer=None,
    params_template: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Any, Dict[str, Any]]:
    """Load a reference ``.pth`` checkpoint (trusted files only: unpickling
    runs code).

    Returns ``(params, opt_state, meta)``: ``params`` in the port's layout
    (``{"conv1": {"w", "b"}, "conv2": {...}, "embed"}``, ``embed`` only
    when the file has ``inputs``); ``opt_state`` None unless ``optimizer``
    (a ``TrainState``) and ``params_template`` are given, then the torch
    Adam moments grafted into its initial state (``adam_state_from_torch``);
    ``meta`` with ``epoch``, ``loss_history``, the translated ``config``
    and the raw ``torch_optimizer`` state when there is one.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_pickle_shim)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    params: Dict[str, Any] = {
        conv: {"w": _cpu(state[f"{conv}.weight"]), "b": _cpu(state[f"{conv}.bias"])}
        for conv in ("conv1", "conv2")
    }
    inputs = ckpt.get("inputs") if isinstance(ckpt, dict) else None
    if inputs is not None:
        params["embed"] = _cpu(inputs)

    meta: Dict[str, Any] = {}
    if isinstance(ckpt, dict):
        meta["epoch"] = int(ckpt.get("epoch", 0))
        meta["loss_history"] = [
            float(x) for x in (ckpt.get("loss_history") or ckpt.get("lossList") or [])]
        meta["config"] = config_from_torch(ckpt.get("config"))
        if ckpt.get("optimizer"):
            meta["torch_optimizer"] = ckpt["optimizer"]

    opt_state = None
    if optimizer is not None and params_template is not None and meta.get("torch_optimizer"):
        opt_state = adam_state_from_torch(optimizer, params_template, meta["torch_optimizer"])
    return params, opt_state, meta


def _adam_leaves(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The Adam entry ``{".count", ".mu", ".nu"}`` of an optax-layout
    state, under ``.inner_state`` when the embedding is masked out."""
    return (opt_state[".inner_state"] if ".inner_state" in opt_state else opt_state)["0"]


def adam_state_from_torch(optimizer, params_template: Dict[str, Any], torch_opt) -> Dict[str, Any]:
    """Graft torch Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` into
    ``optimizer.opt_state()`` (a fresh ``TrainState``'s, the port's layout)
    and return it.  The count is the largest per-parameter step.

    Each moment's shape is checked against ``params_template``
    (``ValueError`` on a mismatch), so a checkpoint of another model size
    fails here.  Only leaves the state holds are replaced: the embedding's
    moments are dropped when the embedding is not trained (adjacency
    features), as the JAX package keeps optax's masked leaf.
    """
    init = optimizer.opt_state()
    per_param = torch_opt.get("state", {})
    if not per_param:
        return init
    adam = _adam_leaves(init)
    count = 0
    for idx, (group, leaf) in enumerate(_PARAM_ORDER):
        s = per_param.get(idx)
        if s is None:
            continue
        count = max(count, int(_cpu(s["step"]).reshape(-1)[0]))
        mu, nu = _cpu(s["exp_avg"]), _cpu(s["exp_avg_sq"])
        tmpl = params_template.get(group)
        if leaf is not None and isinstance(tmpl, dict):
            tmpl = tmpl.get(leaf)
        if tmpl is not None and tuple(tmpl.shape) != tuple(mu.shape):
            raise ValueError(
                f"torch Adam moment {idx} ({group}/{leaf}) has shape "
                f"{tuple(mu.shape)}, template expects {tuple(tmpl.shape)}")
        for key, value in ((".mu", mu), (".nu", nu)):
            parent, name = (adam[key], group) if leaf is None else (adam[key].get(group), leaf)
            if isinstance(parent, dict) and name in parent:
                parent[name] = value.to(parent[name].device, parent[name].dtype)
    adam[".count"] = torch.tensor(count, dtype=torch.int32)
    return init


def save_torch_checkpoint(
    path: str,
    params: Dict[str, Any],
    *,
    epoch: int = 0,
    loss_history: Optional[List[float]] = None,
    config: Optional[TrainingConfig] = None,
    opt_state: Any = None,
) -> str:
    """Write ``params`` (the port's layout) and, given ``opt_state`` (the
    port's optax-layout Adam state), torch Adam's state in the reference's
    ``torch.save`` layout, so that the reference's tooling loads it."""
    def t(x) -> torch.Tensor:
        return _cpu(x).clone()

    state_dict = {
        "conv1.weight": t(params["conv1"]["w"]),
        "conv1.bias": t(params["conv1"]["b"]),
        "conv2.weight": t(params["conv2"]["w"]),
        "conv2.bias": t(params["conv2"]["b"]),
    }
    torch_opt: Dict[str, Any] = {"state": {}, "param_groups": []}
    if opt_state is not None:
        adam = _adam_leaves(opt_state)
        step = torch.tensor(float(adam[".count"]))
        for idx, (group, leaf) in enumerate(_PARAM_ORDER):
            sub_mu, sub_nu = adam[".mu"].get(group), adam[".nu"].get(group)
            if leaf is not None and isinstance(sub_mu, dict):
                sub_mu, sub_nu = sub_mu.get(leaf), sub_nu.get(leaf)
            if sub_mu is None or not hasattr(sub_mu, "shape"):
                continue                                  # an untrained parameter
            torch_opt["state"][idx] = {"step": step, "exp_avg": t(sub_mu),
                                       "exp_avg_sq": t(sub_nu)}
        # one group over all five parameters in the reference's order: torch's
        # load_state_dict needs the live optimizer's parameter count, and
        # opt.step() the saved hyperparameters
        torch_opt["param_groups"] = [{
            "params": list(range(len(_PARAM_ORDER))),
            "lr": config.learning_rate if config is not None else 1e-3,
            "betas": (0.9, 0.999),
            "eps": 1e-8,
            "weight_decay": 0.0,
            "amsgrad": False,
            "maximize": False,
            "foreach": None,
            "capturable": False,
            "differentiable": False,
            "fused": None,
        }]

    ckpt = {
        "epoch": epoch,
        "model": state_dict,
        "optimizer": torch_opt,
        "loss_history": list(loss_history or []),
        "inputs": t(params["embed"]) if "embed" in params else None,
        "config": (types.SimpleNamespace(**dataclasses.asdict(config))
                   if config is not None else None),
    }
    torch.save(ckpt, path)
    logger.info("exported torch checkpoint to %s", path)
    return path
