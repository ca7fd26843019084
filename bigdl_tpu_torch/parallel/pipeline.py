"""Pipeline over stage modules (counterpart of the `Pipeline` class of
bigdl_tpu/parallel/pipeline.py), on one device.

The reference places one stage per device on a 'pipe' mesh axis and
trains with a 1F1B schedule: microbatches stream through `ppermute`
rings, and each device keeps at most 2S stage inputs alive. On one
device that schedule is a loop: microbatch m goes forward through the
stages in order, takes its loss, and goes backward at once, so only one
microbatch's activations are alive at a time. The numbers are the
reference's: the loss is the mean over the M microbatches of each
microbatch's mean loss, and every gradient (stages, pipeline input, loss
parameters) is the sum over microbatches divided by M.

The stages stay `nn.Module`s, children `s0`, `s1`, ...; the reference's
padded flat rows (`_StageMeta`), which exist for `lax.switch`, are only
needed to carry weights across (interop/from_jax.py). The port's stages
keep no state, so there are no state rows, and the reference's `apply`
is the module call. Not ported yet: the multi-device schedule,
`pipeline_apply` and `stack_stage_params` (ROADMAP Queue 1).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from bigdl_tpu_torch.core.module import Module

Tree = Dict[str, torch.Tensor]


class Pipeline(Module):
    """S stage modules run in order over M microbatches.

        pipe = Pipeline([stage0, stage1], n_microbatches=4)
        pipe.init(generator, device=...)
        y = pipe(x)
        loss, grads = pipe.train_step(x, y, loss_fn)

    `Pipeline(block, n_stages=4)` builds four independent copies of
    `block`. Every stage must map a microbatch to the same shape."""

    def __init__(self, stages: Union[Module, Sequence[Module]],
                 n_stages: Optional[int] = None, n_microbatches: int = 8,
                 name=None):
        super().__init__(name)
        if not isinstance(stages, (list, tuple)):
            if n_stages is None:
                raise ValueError("single-module Pipeline needs n_stages")
            stages = [copy.deepcopy(stages) for _ in range(n_stages)]
        self.n_stages = len(stages)
        self.n_microbatches = n_microbatches
        if n_microbatches % self.n_stages:
            raise ValueError(
                f"n_microbatches {n_microbatches} must divide by "
                f"n_stages {self.n_stages} (contiguous input sharding)")
        for i, stage in enumerate(stages):
            self.add_child(f"s{i}", stage)

    @property
    def stages(self):
        return [getattr(self, f"s{i}") for i in range(self.n_stages)]

    def stage_params(self, i: int) -> Tree:
        """Stage i's parameters, {path within the stage: tensor}."""
        return dict(self.stages[i].named_parameters())

    def _microbatches(self, x):
        b, m = x.shape[0], self.n_microbatches
        if b % m:
            raise ValueError(f"batch {b} must divide microbatches {m}")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    def _stages(self, h):
        for stage in self.stages:
            h = stage(h)
        return h

    def forward(self, x):
        """The stages over each microbatch in turn; (batch, ...) out."""
        return torch.cat([self._stages(xm) for xm in self._microbatches(x)])

    def train_step(self, x, y, loss_fn: Callable):
        """One forward and backward pass. `loss_fn(h_mb, y_mb)` is a
        microbatch's mean loss. Returns (mean loss, {stage parameter
        path: gradient})."""
        loss, grads, _, _ = self._train(x, y, loss_fn, None)
        return loss, grads

    def train_step_full(self, x, y, loss_fn: Callable, loss_params: Tree):
        """Like train_step, and also differentiates the pipeline's input
        and the loss's own parameters, so that an embedding before the
        pipeline and a head after it train too. `loss_fn(h_mb, y_mb,
        loss_params)`. Returns (mean loss, stage gradients, d_x shaped
        like x, {loss parameter name: gradient})."""
        if loss_params is None:
            raise ValueError("train_step_full needs loss_params (use "
                             "train_step when the loss has no parameters)")
        return self._train(x, y, loss_fn, loss_params)

    def _train(self, x, y, loss_fn, loss_params):
        m = self.n_microbatches
        xs, ys = self._microbatches(x), self._microbatches(y)
        names = [k for k, _ in self.named_parameters()]
        params = [p for _, p in self.named_parameters()]
        full = loss_params is not None
        lp = ({k: v.detach().requires_grad_() for k, v in
               loss_params.items()} if full else {})
        g_params = [torch.zeros_like(p) for p in params]
        g_lp = {k: torch.zeros_like(v) for k, v in lp.items()}
        d_x = torch.zeros_like(x) if full else None
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        with torch.enable_grad():
            for i in range(m):
                h_in = xs[i].detach().requires_grad_(full)
                h = self._stages(h_in)
                loss_i = (loss_fn(h, ys[i], lp) if full
                          else loss_fn(h, ys[i]))
                wrt = params + ([h_in] + list(lp.values()) if full else [])
                grads = torch.autograd.grad(loss_i, wrt)
                for acc, g in zip(g_params, grads):
                    acc += g
                if full:
                    d_x.view_as(xs)[i] = grads[len(params)]
                    for acc, g in zip(g_lp.values(),
                                      grads[len(params) + 1:]):
                        acc += g
                loss += loss_i.detach()
        stage_grads = {k: g / m for k, g in zip(names, g_params)}
        if not full:
            return loss / m, stage_grads, None, None
        return (loss / m, stage_grads, d_x / m,
                {k: g / m for k, g in g_lp.items()})
