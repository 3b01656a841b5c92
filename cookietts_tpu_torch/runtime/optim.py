"""Adam, LAMB, the plateau LR scheduler, the fp16 loss scaler and the
gradient utilities of the trainers (cookietts_tpu/runtime/optim.py:40-198).

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

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

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


def lamb(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0, min_trust: float = 0.0,
         max_trust: float = 10.0) -> Optimizer:
    """LAMB: Adam's direction without bias correction, each tensor's step
    scaled by the trust ratio ||p|| / ||direction|| (clamped; 1 where either
    norm is 0). The vocoder trainer's ``optimizer=lamb``."""

    def init(params: Tree) -> AdamState:
        return AdamState(0, _zeros_like(params), _zeros_like(params))

    def update(grads: Tree, state: AdamState, params: Tree = None, lr=1e-4):
        if params is None:
            raise ValueError("LAMB needs the parameters for its trust ratio")
        mu, nu, updates = {}, {}, {}
        for name, m in state.mu.items():
            g = _grad(grads, name, m).to(m.dtype)
            mu[name] = b1 * m + (1 - b1) * g
            nu[name] = b2 * state.nu[name] + (1 - b2) * g * g
            a = mu[name] / (torch.sqrt(nu[name]) + eps)
            p = params[name]
            if weight_decay:
                a = a + weight_decay * p
            w_norm, a_norm = p.norm(), a.norm()
            trust = torch.where((w_norm > 0) & (a_norm > 0),
                                (w_norm / a_norm).clamp(min_trust, max_trust),
                                torch.ones_like(w_norm))
            updates[name] = -lr * trust * a
        return updates, AdamState(state.step + 1, mu, nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place (the parameters keep their storage)."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))


def global_norm(tree: Tree, layout=None) -> torch.Tensor:
    """The L2 norm of every tensor of ``tree``. Under a tp ``layout``
    (parallel/tp.py) the squares of its sharded entries are summed over the
    tp group and the replicated ones counted once: the norm of the full
    tree, the same on every rank."""
    if layout is None:
        return torch.sqrt(sum((x.float() ** 2).sum() for x in tree.values()
                              if x is not None))
    sq = [(x.float() ** 2).sum() for k, x in tree.items()
          if x is not None and k not in layout.names]
    sh = [(x.float() ** 2).sum() for k, x in tree.items()
          if x is not None and k in layout.names]
    total = sum(sq) if sq else 0.0
    if sh:
        total = total + layout.tp.all_reduce(torch.stack(sh).sum())
    return torch.sqrt(torch.as_tensor(total))


def clip_by_global_norm(grads: Tree, max_norm, layout=None
                        ) -> Tuple[Tree, torch.Tensor]:
    """(clipped grads, pre-clip norm). The scale is min(1, max_norm /
    (norm + 1e-6)); a non-finite norm zeroes every gradient (the step is
    skipped). No host sync: the norm stays on the device. ``layout``: the
    model's tp layout, whose sharded gradients count over the group."""
    norm = global_norm(grads, layout)
    finite = torch.isfinite(norm)
    scale = torch.where(finite, torch.clamp(max_norm / (norm + 1e-6), max=1.0),
                        torch.zeros_like(norm))
    clipped = {k: None if g is None else
               torch.where(finite, g * scale.to(g.dtype), torch.zeros_like(g))
               for k, g in grads.items()}
    return clipped, norm


@dataclasses.dataclass
class DynamicLossScaler:
    """fp16 dynamic loss scaling (cookietts_tpu/runtime/optim.py:143; the
    reference's loss_scaler.py:31-69): start at ``scale``, multiply it by
    ``scale_factor`` after ``scale_window`` steps without overflow, divide
    it on an overflow (never below 1). No trainer calls it yet: it waits
    for reduced-precision training."""
    scale: float = 2.0 ** 17
    scale_factor: float = 2.0
    scale_window: int = 1000
    _good_steps: int = 0

    def unscale(self, grads: Any) -> Any:
        """Every tensor of a tree (dicts, lists, tuples) times 1 / scale;
        None leaves stay None."""
        s = 1.0 / self.scale
        return pytree.tree_map(lambda g: None if g is None else g * s,
                               grads)

    def step(self, overflow: bool) -> None:
        if overflow:
            self.scale = max(self.scale / self.scale_factor, 1.0)
            self._good_steps = 0
        else:
            self._good_steps += 1
            if self._good_steps >= self.scale_window:
                self.scale *= self.scale_factor
                self._good_steps = 0


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Plateau LR multiplier, stepped with each validation's loss: after
    more than ``patience`` validations without a relative improvement of
    ``threshold``, ``scale`` drops by ``factor``. The trainer applies it as
    ``lr = max(base_lr * scale, min(min_lr, base_lr))``: ``min_lr`` floors
    the effective rate (torch's semantics), never raising it above the base
    schedule."""
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-6
    threshold: float = 1e-4
    scale: float = 1.0
    _best: float = float("inf")
    _bad_steps: int = 0

    def step(self, metric: float) -> float:
        if metric < self._best * (1.0 - self.threshold):
            self._best = metric
            self._bad_steps = 0
        else:
            self._bad_steps += 1
            if self._bad_steps > self.patience:
                self.scale = max(self.scale * self.factor, 1e-12)
                self._bad_steps = 0
        return self.scale
