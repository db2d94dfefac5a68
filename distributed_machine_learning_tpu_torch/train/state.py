"""Training state.

Counterpart of ``distributed_machine_learning_tpu/train/state.py``.  The
reference's state is an immutable pytree; here it is a small mutable
record: the model holds the f32 parameters, ``momentum`` the optimizer's
buffers (AdamW: ``{"mu": {name: tensor}, "nu": {...}}``), ``step`` the
number of applied updates as a host int.  A step updates it in place.
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
    config: AdamWConfig

    @property
    def params(self) -> dict:
        """The model's parameters by name (the live tensors)."""
        return dict(self.model.named_parameters())

    @classmethod
    def create(cls, model: nn.Module, config=None) -> "TrainState":
        from distributed_machine_learning_tpu_torch.train.optimizers import (
            init_for_config,
        )

        config = config or AdamWConfig()
        params = dict(model.named_parameters())
        return cls(model=model, momentum=init_for_config(config)(params), step=0,
                   config=config)
