"""Optimization methods (counterpart of bigdl_tpu/optim/method.py): SGD,
Adam, AdamW and RMSprop, the methods `models/train.py` builds.

Each method is a pure pair over dicts of tensors keyed by the params
tree's dotted paths (core/module.py):
    slots = method.init_slots(params)
    new_params, new_slots = method.update(params, grads, slots, lr, step)
Nothing is updated in place; the trainer binds the returned tensors.
This is the tree-map oracle the fused update (kernels/fused_update.py)
is held to bit for bit.

Scalar rounding follows the reference, where `lr` is a traced fp32
scalar and the hyperparameters are weak-typed Python floats: `lr` is a
0-dim fp32 tensor (so `lr * wd` rounds in fp32), a Python constant
meets a tensor as fp32, and the Adam bias corrections `1 - b ** t` are
computed in fp32 (`bias_correction`). A division by a bias correction
divides by a 0-dim tensor on the parameters' device: a CPU scalar
divisor would take torch's reciprocal-multiply shortcut on CUDA and
round differently from a division.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bigdl_tpu_torch.optim.schedule import Default, LearningRateSchedule

Tree = Dict[str, torch.Tensor]


def bias_correction(beta: float, t: int) -> float:
    """1 - beta ** t in fp32, as the reference computes `1 - b1 ** t`
    with `t` an int32 array: the exact fp32 value, as a Python float."""
    return float(1 - torch.tensor(beta, dtype=torch.float32) ** t)


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on `like`'s device, filled without a copy
    from the host."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def as_lr(lr) -> torch.Tensor:
    """The learning rate as the 0-dim fp32 CPU tensor the update takes
    (the reference's `jnp.float32(lr)`)."""
    return torch.as_tensor(lr, dtype=torch.float32).reshape(())


class OptimMethod:
    """Base optimizer. `learning_rate_schedule` runs on the host via
    `current_lr(state)`; `state` carries the trainer's neval/epoch
    counters."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.schedule = learning_rate_schedule or Default()
        self.weight_decay = weight_decay

    def current_lr(self, state: Dict) -> float:
        return float(self.schedule(self.learning_rate, state))

    def init_slots(self, params: Tree) -> Dict[str, Tree]:
        return {}

    def update(self, params: Tree, grads: Tree, slots, lr, step: int):
        raise NotImplementedError

    def _decay(self, params: Tree, grads: Tree) -> Tree:
        if self.weight_decay == 0.0:
            return grads
        wd = self.weight_decay
        return {k: g + wd * params[k] for k, g in grads.items()}


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p) for k, p in params.items()}


class SGD(OptimMethod):
    """SGD with momentum/dampening/nesterov (Torch update order: decay,
    momentum buffer, step)."""

    def __init__(self, learning_rate: float = 1e-3, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.momentum = momentum
        # dampening defaults to momentum; nesterov needs a momentum and
        # zero dampening (the reference's SGD.scala rules)
        if dampening is None:
            dampening = 0.0 if nesterov else momentum
        self.dampening = dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")

    def init_slots(self, params):
        if self.momentum == 0.0:
            return {}
        return {"velocity": _zeros(params)}

    def update(self, params, grads, slots, lr, step):
        lr = as_lr(lr)
        g = self._decay(params, grads)
        if self.momentum == 0.0:
            return {k: p - lr * g[k] for k, p in params.items()}, slots
        mu, damp = self.momentum, self.dampening
        v = {k: mu * vv + (1 - damp) * g[k]
             for k, vv in slots["velocity"].items()}
        upd = {k: g[k] + mu * v[k] for k in g} if self.nesterov else v
        return ({k: p - lr * upd[k] for k, p in params.items()},
                {"velocity": v})


class Adam(OptimMethod):
    """Bias-corrected Adam; weight decay folds `wd * p` into the
    gradient."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(self, params, grads, slots, lr, step):
        lr = as_lr(lr)
        g = self._decay(params, grads)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = step + 1
        m = {k: b1 * mm + (1 - b1) * g[k] for k, mm in slots["m"].items()}
        v = {k: b2 * vv + (1 - b2) * (g[k] * g[k])
             for k, vv in slots["v"].items()}
        if not params:
            return params, {"m": m, "v": v}
        like = next(iter(params.values()))
        bc1 = device_scalar(bias_correction(b1, t), like)
        bc2 = device_scalar(bias_correction(b2, t), like)
        new_params = {k: p - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                      for k, p in params.items()}
        return new_params, {"m": m, "v": v}


class AdamW(Adam):
    """Decoupled weight decay: Adam without the gradient decay, then
    `p' - lr * wd * p`."""

    def update(self, params, grads, slots, lr, step):
        lr = as_lr(lr)
        wd = self.weight_decay
        self.weight_decay = 0.0
        try:
            new_params, new_slots = super().update(params, grads, slots, lr,
                                                   step)
        finally:
            self.weight_decay = wd
        if wd:
            new_params = {k: np_ - lr * wd * params[k]
                          for k, np_ in new_params.items()}
        return new_params, new_slots


class RMSprop(OptimMethod):
    """RMSprop: a running mean of squared gradients scales the step."""

    def __init__(self, learning_rate: float = 1e-2, decay_rate: float = 0.99,
                 epsilon: float = 1e-8,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule)
        self.rho, self.epsilon = decay_rate, epsilon

    def init_slots(self, params):
        return {"sq_avg": _zeros(params)}

    def update(self, params, grads, slots, lr, step):
        lr = as_lr(lr)
        rho = self.rho
        sq = {k: rho * s + (1 - rho) * (grads[k] * grads[k])
              for k, s in slots["sq_avg"].items()}
        new_params = {k: p - lr * grads[k] / (torch.sqrt(sq[k]) + self.epsilon)
                      for k, p in params.items()}
        return new_params, {"sq_avg": sq}


def init_update_slots(method: OptimMethod, params: Tree):
    """Slots for `apply_update`: the method's own slot trees and the step
    counter, a host int that `apply_update` advances."""
    return (method.init_slots(params), 0)


def apply_update(method: Optional[OptimMethod], params: Tree, grads: Tree,
                 slots, sgd_lr: float = 1e-3):
    """One optimizer update outside the trainer (the pipelined LM's step).
    `method=None` is plain SGD at `sgd_lr`, `p - sgd_lr * g`. Otherwise
    the method's learning rate and schedule set the rate, the schedule
    running on the host at the slots' step counter (a constant rate reads
    nothing from the card), and the counter advances. Returns
    (new_params, new_slots)."""
    if method is None:
        return {k: p - sgd_lr * grads[k] for k, p in params.items()}, slots
    inner, t = slots
    sched = method.schedule
    if isinstance(sched, Default) and sched.lr_decay == 0.0:
        lr = method.learning_rate
    else:
        lr = method.current_lr({"neval": t, "epoch": 0})
    new_params, new_inner = method.update(params, grads, inner, lr, t)
    return new_params, (new_inner, t + 1)
