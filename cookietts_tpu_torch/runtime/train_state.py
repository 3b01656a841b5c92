"""Train state shared by the trainer (cookietts_tpu/runtime/train_state.py):
the step, the model (its trainable parameters and buffers such as the
BatchNorm statistics) and the optimizer state; ``GANTrainState`` pairs a
generator's with its discriminators'.

The trainable parameters are the model's parameters that require a
gradient, keyed by their ``state_dict`` names; the frozen half of each
split LSTM bias stays out of the optimizer. Under tensor parallelism
(parallel/tp.py) they are this rank's shards, and so are the moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from ..parallel.tp import layout_of
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
        (every parameter and buffer), the optimizer state. A model sharded
        over a tp group gives the full, gathered tree (a collective: every
        rank of the group calls it), the file one process writes."""
        layout = layout_of(self.model)
        full = (lambda d: d) if layout is None else layout.gather
        cpu = lambda d: {k: t.detach().to("cpu", copy=True)  # noqa: E731
                         for k, t in full(d).items()}
        opt = self.opt_state
        return {"step": int(self.step),
                "state_dict": cpu(self.model.state_dict()),
                "opt_state": {"step": int(opt.step), "mu": cpu(opt.mu),
                              "nu": cpu(opt.nu)}}


@dataclasses.dataclass
class GANTrainState:
    """A generator's and its discriminators' states, so an adversarial
    trainer rides the same Trainer. ``step``, ``model`` and ``params`` are
    the generator's; its checkpoint keeps G under the usual keys and D
    under ``d_state_dict`` / ``d_opt_state``."""
    g: TrainState
    d: TrainState

    @property
    def step(self) -> int:
        return self.g.step

    @property
    def model(self) -> nn.Module:
        return self.g.model

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.g.params

    def to_host_tree(self) -> Dict[str, Any]:
        d = self.d.to_host_tree()
        return {**self.g.to_host_tree(), "d_state_dict": d["state_dict"],
                "d_opt_state": d["opt_state"]}
