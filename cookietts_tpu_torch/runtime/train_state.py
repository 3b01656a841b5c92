"""Train state shared by the trainer (cookietts_tpu/runtime/train_state.py):
the step, the model (its trainable parameters and buffers such as the
BatchNorm statistics) and the optimizer state.

The trainable parameters are the model's parameters that require a
gradient, keyed by their ``state_dict`` names; the frozen half of each
split LSTM bias stays out of the optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from .optim import Optimizer, apply_updates


def trainable(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Any
    tx: Optimizer

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        return cls(0, model, tx.init(trainable(model)), tx)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return trainable(self.model)

    def apply_gradients(self, grads: Dict[str, torch.Tensor], lr) -> None:
        """One optimizer step, in place; the step count moves on."""
        params = self.params
        updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                 params, lr=lr)
        apply_updates(params, updates)
        self.step += 1

    def to_host_tree(self) -> Dict[str, Any]:
        """The checkpoint payload on the CPU: step, the model's state dict
        (every parameter and buffer), the optimizer state."""
        cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        opt = self.opt_state
        return {"step": int(self.step),
                "state_dict": {k: cpu(v) for k, v in
                               self.model.state_dict().items()},
                "opt_state": {"step": int(opt.step),
                              "mu": {k: cpu(v) for k, v in opt.mu.items()},
                              "nu": {k: cpu(v) for k, v in opt.nu.items()}}}
