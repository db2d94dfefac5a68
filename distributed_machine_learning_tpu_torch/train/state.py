"""Training state.

Counterpart of ``distributed_machine_learning_tpu/train/state.py``.  The
reference's state is an immutable pytree; here it is a small mutable
record: the model holds the f32 parameters (and BatchNorm's running
statistics, as buffers), ``momentum`` the optimizer's buffers (AdamW:
``{"mu": {name: tensor}, "nu": {...}}``; SGD: ``{name: tensor}``), ``step``
the number of applied updates as a host int.  A step updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig


@dataclass
class TrainState:
    model: nn.Module
    momentum: dict
    step: int
    config: object  # AdamWConfig or SGDConfig: the update dispatches on its type

    @property
    def params(self) -> dict:
        """The model's parameters by name (the live tensors)."""
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict:
        """BatchNorm's running statistics by name (empty for a BN-free model)."""
        return {k: b for k, b in self.model.named_buffers() if k.endswith(("running_mean",
                                                                           "running_var"))}

    @classmethod
    def create(cls, model: nn.Module, config=None) -> "TrainState":
        from distributed_machine_learning_tpu_torch.train.optimizers import (
            init_for_config,
        )

        config = config or AdamWConfig()
        params = dict(model.named_parameters())
        return cls(model=model, momentum=init_for_config(config)(params), step=0,
                   config=config)
