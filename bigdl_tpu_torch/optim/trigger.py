"""Triggers — when to stop / validate (counterpart of
bigdl_tpu/optim/trigger.py: every_epoch, several_iteration, max_epoch,
max_iteration, min_loss, max_score, and/or)."""

from __future__ import annotations

from typing import Dict


class Trigger:
    def __call__(self, state: Dict) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(n: int):
        return _SeveralIteration(n)

    @staticmethod
    def max_epoch(n: int):
        return _Lambda(lambda s: s.get("epoch", 0) >= n)

    @staticmethod
    def max_iteration(n: int):
        return _Lambda(lambda s: s.get("neval", 0) >= n)

    @staticmethod
    def min_loss(v: float):
        return _Lambda(lambda s: s.get("loss", float("inf")) <= v)

    @staticmethod
    def max_score(v: float):
        return _Lambda(lambda s: s.get("score", float("-inf")) >= v)

    @staticmethod
    def and_(*triggers: "Trigger"):
        return _Lambda(lambda s: all(t(s) for t in triggers))

    @staticmethod
    def or_(*triggers: "Trigger"):
        return _Lambda(lambda s: any(t(s) for t in triggers))


class _Lambda(Trigger):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state):
        return bool(self.fn(state))


class _EveryEpoch(Trigger):
    """Fires when the epoch counter advances past the last fire."""

    def __init__(self):
        self.last = None

    def __call__(self, state):
        e = state.get("epoch", 0)
        fire = state.get("epoch_finished", False) and e != self.last
        if fire:
            self.last = e
        return fire


class _SeveralIteration(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        it = state.get("neval", 0)
        return it > 0 and it % self.n == 0
