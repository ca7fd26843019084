"""Criterions (counterpart of bigdl_tpu/nn/criterion.py): the ones LM
training uses. Pure `(input, target) -> scalar`; gradients come from
autograd.

Conventions, as in the reference: class targets are 0-based integers
(int32 there; cast to int64 here at the gather, which torch needs);
`size_average=True` averages over the batch, False sums."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.core.module import Criterion


def _reduce(x, size_average: bool):
    return torch.mean(x) if size_average else torch.sum(x)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (B, C), or over
    logits with `logits=True`. Optional per-class `weights`; targets
    equal to `ignore_index` contribute 0. With size_average the loss is
    the weighted sum over the total weight."""

    def __init__(self, weights=None, size_average: bool = True,
                 logits: bool = False, ignore_index: Optional[int] = None):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average
        self.logits = logits
        self.ignore_index = ignore_index

    def _terms(self, input, target):
        """(nll * w, w), elementwise over the target's shape."""
        logp = torch.log_softmax(input, dim=-1) if self.logits else input
        t = target.long()
        safe_t = torch.where(t < 0, 0, t)
        nll = -torch.gather(logp, -1, safe_t[..., None])[..., 0]
        w = torch.ones_like(nll)
        if self.weights is not None:
            w = self.weights.to(nll.device)[safe_t]
        if self.ignore_index is not None:
            w = torch.where(t == self.ignore_index, 0.0, w)
        return nll * w, w

    def _total(self, nw, w, dims):
        if self.size_average:
            return nw.sum(dims) / torch.clamp(w.sum(dims), min=1e-8)
        return nw.sum(dims)

    def forward(self, input, target):
        nw, w = self._terms(input, target)
        return self._total(nw, w, tuple(range(nw.ndim)))

    def step_losses(self, input, target):
        """forward() of every slice along axis 0 of the target, in one
        pass: input (S, ..., C), target (S, ...) -> (S,)."""
        nw, w = self._terms(input, target)
        return self._total(nw, w, tuple(range(1, nw.ndim)))


class CrossEntropyCriterion(ClassNLLCriterion):
    """LogSoftMax + ClassNLL fused: the input is logits."""

    def __init__(self, weights=None, size_average: bool = True,
                 ignore_index: Optional[int] = None):
        super().__init__(weights, size_average, logits=True,
                         ignore_index=ignore_index)


class TimeDistributedCriterion(Criterion):
    """Applies a criterion per step along `dimension` and sums the steps
    (their mean with size_average). The reference loops over the T
    steps; here the inner criterion's per-step losses come from one
    vectorized pass (`step_losses`), so a step costs a few launches
    instead of a few per time step. The sum over T then runs in another
    order than the reference's left-to-right loop: ~1e-6 relative."""

    def __init__(self, criterion: ClassNLLCriterion,
                 size_average: bool = False, dimension: int = 1):
        if not hasattr(criterion, "step_losses"):
            raise TypeError(f"{type(criterion).__name__} has no vectorized "
                            f"step_losses; the port's TimeDistributed"
                            f"Criterion takes ClassNLL/CrossEntropy")
        self.criterion = criterion
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        steps = self.criterion.step_losses(
            torch.movedim(input, self.dimension, 0),
            torch.movedim(target, self.dimension, 0))
        return _reduce(steps, self.size_average)
