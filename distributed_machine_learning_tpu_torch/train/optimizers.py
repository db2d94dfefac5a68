"""Optimizer registry: name → (config class, init, update).

Counterpart of ``distributed_machine_learning_tpu/train/optimizers.py``.
Every update fn shares the signature ``(params, moments, grads, config,
lr=None, step=None) -> (params, moments)`` and updates in place.
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.train.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from distributed_machine_learning_tpu_torch.train.lars import LARSConfig, lars_update
from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig, sgd_init, sgd_update

OPTIMIZERS = {
    "sgd": (SGDConfig, sgd_init, sgd_update),
    "lars": (LARSConfig, sgd_init, lars_update),
    "adamw": (AdamWConfig, adamw_init, adamw_update),
}


def optimizer_names() -> list[str]:
    return sorted(OPTIMIZERS)


def get_optimizer(name: str):
    """(config_class, init_fn, update_fn) for ``name``."""
    try:
        return OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; choose from "
                         f"{optimizer_names()}") from None


def _entry_for_config(config):
    for entry in OPTIMIZERS.values():
        if type(config) is entry[0]:
            return entry
    raise ValueError(f"no registered optimizer for config type "
                     f"{type(config).__name__} (registered: {sorted(OPTIMIZERS)})")


def config_class_by_name(class_name: str):
    """Config class by its ``__name__`` (a checkpoint's ``__class__``)."""
    for cfg_cls, _init, _update in OPTIMIZERS.values():
        if cfg_cls.__name__ == class_name:
            return cfg_cls
    raise ValueError(f"unknown optimizer config class in checkpoint: {class_name!r}")


def init_for_config(config):
    """Moments init fn for a config instance, with the config bound in."""
    init = _entry_for_config(config)[1]
    return lambda params: init(params, config)


def update_fn_for_config(config):
    """Update fn for a config instance."""
    return _entry_for_config(config)[2]


def moment_layout(param_specs: dict, params: dict, momentum):
    """Project a per-parameter entry (a shard spec, by name) onto the
    momentum slot: the slot is either params-shaped (SGD: ``{name:
    tensor}``) or a dict of params-shaped moment dicts (AdamW's ``{"mu",
    "nu"}``); each moment inherits its parameter's entry.  One definition
    for every sharded layout (``parallel/gspmd.py``)."""
    if momentum is None:
        return param_specs
    names = set(params)
    if set(momentum) == names and not any(isinstance(v, dict) for v in momentum.values()):
        return param_specs
    if isinstance(momentum, dict) and all(
            isinstance(v, dict) and set(v) == names for v in momentum.values()):
        return {k: param_specs for k in momentum}
    raise ValueError("momentum layout matches neither the param tree nor a dict of "
                     "param-shaped moment trees; cannot derive its specs")
