"""Adam and the gradient utilities of the Tacotron2 trainer
(cookietts_tpu/runtime/optim.py:40-140).

Functional, like the JAX version: parameters, gradients and moments are
dicts {name: tensor} keyed by ``state_dict`` names.

    opt = adam(); state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr=1e-4)
    apply_updates(params, updates)            # in place

The arithmetic follows JAX's in float32, bias corrections included, so one
step moves the parameters as the JAX package's does. A gradient that is
None (a parameter the loss does not reach) counts as zeros.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]


class AdamState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def _zeros_like(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _grad(grads: Tree, name: str, like: torch.Tensor) -> torch.Tensor:
    g = grads.get(name)
    return torch.zeros_like(like) if g is None else g


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0)."""

    def init(params: Tree) -> AdamState:
        return AdamState(0, _zeros_like(params), _zeros_like(params))

    def update(grads: Tree, state: AdamState, params: Tree = None, lr=1e-4):
        step = state.step + 1
        mu, nu, updates = {}, {}, {}
        f32 = lambda x, like: torch.as_tensor(x, dtype=torch.float32,
                                               device=like.device)
        for name, m in state.mu.items():
            g = _grad(grads, name, m).to(m.dtype)
            mu[name] = b1 * m + (1 - b1) * g
            nu[name] = b2 * state.nu[name] + (1 - b2) * g * g
            # bias corrections in float32, as JAX computes them
            bc1 = 1 - f32(b1, m) ** step
            bc2 = 1 - f32(b2, m) ** step
            u = -lr * (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + eps)
            if weight_decay and params is not None:
                u = u - lr * weight_decay * params[name]
            updates[name] = u
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place (the parameters keep their storage)."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tree.values()
                          if x is not None))


def clip_by_global_norm(grads: Tree, max_norm) -> Tuple[Tree, torch.Tensor]:
    """(clipped grads, pre-clip norm). The scale is min(1, max_norm /
    (norm + 1e-6)); a non-finite norm zeroes every gradient (the step is
    skipped). No host sync: the norm stays on the device."""
    norm = global_norm(grads)
    finite = torch.isfinite(norm)
    scale = torch.where(finite, torch.clamp(max_norm / (norm + 1e-6), max=1.0),
                        torch.zeros_like(norm))
    clipped = {k: None if g is None else
               torch.where(finite, g * scale.to(g.dtype), torch.zeros_like(g))
               for k, g in grads.items()}
    return clipped, norm
