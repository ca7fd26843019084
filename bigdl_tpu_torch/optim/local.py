"""Single-device trainer (counterpart of bigdl_tpu/optim/local.py): the
`Optimizer` builder facade and its per-step training loop, on one CUDA
card (or the CPU when asked).

The reference jits one pure train step over `(params, model_state,
slots)` trees. Here the step runs eagerly: the model holds its
parameters (core/module.py), the step takes the gradients of the loss
with `torch.autograd.grad`, hands them to the update (the tree-map
`method.update`, or the fused update of kernels/fused_update.py under
BIGDL_TPU_FUSED_UPDATE) and binds the updated tensors back to the
model. The params tree is the dict `{dotted path: parameter}`.

Ported: the constructor and builders, gradient clipping, gradient
accumulation, the fused-update seam with its one-time fallback warning,
and the per-step loop with its state counters, buffered loss fetch,
throughput log and non-finite guard. Not ported yet (ROADMAP): running
validation (optim/metrics.py), checkpoints and resume, the K-step scan
(`steps_per_call` > 1; its counterpart is a CUDA graph), the data
service and prefetch, DCN exchange and failover, AOT precompile, the
compile cache and the flight recorder.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Criterion, Module
from bigdl_tpu_torch.optim.method import SGD, OptimMethod, as_lr
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.platform import resolve_device

log = logging.getLogger("bigdl_tpu_torch")

Tree = Dict[str, torch.Tensor]


class NonFiniteLossError(RuntimeError):
    """Training aborted: BIGDL_TPU_MAX_NONFINITE consecutive non-finite
    training steps."""


# ------------------------------------------------- gradient processors
class GradientProcessor:
    """Pluggable gradient transform over the grads dict."""

    def __call__(self, grads: Tree, params: Tree) -> Tree:
        return grads


class ConstantClipping(GradientProcessor):
    def __init__(self, min_value: float, max_value: float):
        self.min_value, self.max_value = min_value, max_value

    def __call__(self, grads, params):
        return {k: torch.clamp(g, self.min_value, self.max_value)
                for k, g in grads.items()}


class L2NormClipping(GradientProcessor):
    """Global-norm clip: every gradient scaled by min(1, max_norm /
    (norm + 1e-12))."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def __call__(self, grads, params):
        sq = sum(torch.sum(g * g) for g in grads.values())
        norm = torch.sqrt(sq)
        scale = torch.clamp(self.max_norm / (norm + 1e-12), max=1.0)
        return {k: g * scale for k, g in grads.items()}


class Optimizer:
    """Training facade. Usage mirrors the reference:

        opt = Optimizer(model, dataset, criterion, Adam(3e-4))
        opt.set_end_when(Trigger.max_iteration(100))
        params, model_state = opt.optimize()

    `dataset` is any object whose `__iter__` yields (x, y) numpy or
    tensor batches per epoch (see bigdl_tpu_torch.dataset). The trainer
    runs on `device` (default `cuda`; no card raises) and moves the
    model there. A model whose parameters are not drawn yet is drawn
    from `seed`, as the reference's trainer draws its params tree;
    otherwise training starts from the model's current weights.
    `optimize()` returns `(params, model_state)` as `{path: tensor}`
    dicts; the ported modules keep no state, so model_state is empty.
    The optimizer slots start from `self.slots` when it is set (by an
    earlier optimize() of this trainer, or by the caller, e.g. with a
    reference tree through interop/from_jax.slots_from_jax), else from
    `method.init_slots`; they are left in `self.slots`.
    """

    def __init__(self, model: Module, dataset, criterion: Criterion,
                 optim_method: Optional[OptimMethod] = None,
                 seed: Optional[int] = None,
                 steps_per_call: Optional[int] = None,
                 accum_steps: Optional[int] = None, device=None):
        from bigdl_tpu_torch.utils import config
        if seed is None:
            seed = config.get("SEED")
        if steps_per_call is None:
            steps_per_call = config.get("STEPS_PER_CALL")
        if accum_steps is None:
            accum_steps = config.get("ACCUM_STEPS")
        if steps_per_call < 1 or accum_steps < 1:
            raise ValueError(
                f"steps_per_call ({steps_per_call}) and accum_steps "
                f"({accum_steps}) must be >= 1")
        if steps_per_call > 1:
            raise NotImplementedError(
                f"steps_per_call={steps_per_call}: the K-step scan is not "
                f"ported (its CUDA-graph counterpart is a ROADMAP item, "
                f"slice 2 leftovers); use 1")
        self.device = resolve_device(device)
        self.steps_per_call = 1
        self.accum_steps = int(accum_steps)
        self.model, self.dataset, self.criterion = model, dataset, criterion
        self.method = optim_method or SGD(1e-2)
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset = None
        self.val_methods: Sequence = ()
        self.grad_processors: List[GradientProcessor] = []
        self.seed = seed
        self.state: Dict = {"epoch": 0, "neval": 0, "records": 0,
                            "batch_in_epoch": 0}
        self._log_every = max(1, config.get("LOG_THROUGHPUT_EVERY"))
        self._max_nonfinite = config.get("MAX_NONFINITE")
        self._nonfinite_run = 0
        self._summary = None
        self.slots: Optional[Dict[str, Tree]] = None

    # ------------------------------------------------------------- builders
    def set_optim_method(self, method: OptimMethod):
        self.method = method
        return self

    def set_end_when(self, trigger: Trigger):
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset, methods: Sequence):
        """Recorded; running it needs optim/metrics.py, which is not
        ported yet, so optimize() refuses a trainer that has it set."""
        self.val_trigger, self.val_dataset, self.val_methods = \
            trigger, dataset, list(methods)
        return self

    def set_gradient_clipping_by_l2_norm(self, max_norm: float):
        self.grad_processors.append(L2NormClipping(max_norm))
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float):
        self.grad_processors.append(ConstantClipping(min_v, max_v))
        return self

    def set_accum_steps(self, m: int):
        """Gradient accumulation: split each batch into M microbatches,
        average their gradients, apply one optimizer update. The batch
        dimension must divide by M."""
        if m < 1:
            raise ValueError(f"accum_steps must be >= 1, got {m}")
        self.accum_steps = int(m)
        return self

    def set_train_summary(self, summary):
        """Any object with `add_scalar(tag, value, step)`: receives
        Loss, LearningRate and Throughput of every step at each flush."""
        self._summary = summary
        return self

    # ------------------------------------------------------------ step build
    def _grads(self, params: Tree, x, y):
        """(loss, grads) of one (micro)batch, the model in training
        mode."""
        self.model.train()
        out = self.model(x)
        loss = self.criterion.forward(out, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params.keys(), grads))

    def _apply_update(self, method_update, params, grads, slots, lr,
                      step_num, frozen, guard_loss=None):
        """Gradient processors, the update, and freeze: a frozen leaf
        keeps its value whatever the update rule does (its slots still
        advance, as in the reference). With `guard_loss` (the
        accumulating step, which the reference runs inside its guarded
        scan) a step whose loss or updated params are not all finite is
        masked on the device: params and slots keep their old values and
        the non-finite loss still reaches `_flush_metrics`."""
        for proc in self.grad_processors:
            grads = proc(grads, params)
        with torch.no_grad():
            kept = {}
            if frozen:
                mask = self.model.trainable_mask(params)
                kept = {k: params[k].clone() for k, ok in mask.items()
                        if not ok}
            if guard_loss is not None:   # the fused update works in place
                old_p = {k: p.clone() for k, p in params.items()}
                old_s = {nm: {k: s.clone() for k, s in sl.items()}
                         for nm, sl in slots.items()}
            new_params, new_slots = method_update(params, grads, slots, lr,
                                                  step_num)
            for k, p in params.items():
                if k in kept:
                    p.copy_(kept[k])
                elif new_params[k] is not p:   # the fused kernel is in place
                    p.data = new_params[k]
            if guard_loss is not None:
                ok = torch.isfinite(guard_loss)
                for p in params.values():
                    if p.is_floating_point():
                        ok = ok & torch.isfinite(p).all()
                for k, p in params.items():
                    p.copy_(torch.where(ok, p, old_p[k]))
                new_slots = {nm: {k: torch.where(ok, s, old_s[nm][k])
                                  for k, s in sl.items()}
                             for nm, sl in new_slots.items()}
        return new_slots

    def _make_step(self) -> Callable:
        """The train step: `step(params, slots, x, y, lr, step_num) ->
        (slots, loss)`; params (the model's parameters) are updated in
        place."""
        frozen = any(getattr(m, "_frozen", False)
                     for m in self.model.modules())
        method_update = self._resolve_update_fn()

        def step(params, slots, x, y, lr, step_num):
            loss, grads = self._grads(params, x, y)
            slots = self._apply_update(method_update, params, grads, slots,
                                       lr, step_num, frozen)
            return slots, loss

        return step

    def _make_accum_step(self, accum_steps: int) -> Callable:
        """Gradient-accumulation variant of `_make_step`: the batch is
        split into `accum_steps` microbatches whose gradients (and mean
        losses) are summed from zero and divided by M, then ONE update is
        applied — equal microbatches make that the full-batch mean. A
        non-finite step is masked, as in the reference's scan step."""
        frozen = any(getattr(m, "_frozen", False)
                     for m in self.model.modules())
        method_update = self._resolve_update_fn()
        M = accum_steps

        def step(params, slots, x, y, lr, step_num):
            if x.shape[0] % M:
                raise ValueError(
                    f"batch of {x.shape[0]} rows does not divide into "
                    f"accum_steps={M} microbatches")
            gsum = {k: torch.zeros_like(p) for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=x.device)
            for xm, ym in zip(x.chunk(M), y.chunk(M)):
                loss, grads = self._grads(params, xm, ym)
                gsum = {k: gsum[k] + g for k, g in grads.items()}
                lsum = lsum + loss
            grads = {k: g / M for k, g in gsum.items()}
            loss = lsum / M
            slots = self._apply_update(method_update, params, grads, slots,
                                       lr, step_num, frozen, guard_loss=loss)
            return slots, loss

        return step

    def _resolve_update_fn(self) -> Callable:
        """The update callable: `method.update` (the tree-map oracle),
        or the fused update (kernels/fused_update.py) when
        BIGDL_TPU_FUSED_UPDATE is set and the method has a fused form
        (Adam/AdamW/SGD). An unsupported method under the flag logs once
        and keeps the oracle — the knob never changes which methods
        train correctly."""
        from bigdl_tpu_torch.kernels import fused_update as _fu
        if not _fu.enabled():
            return self.method.update
        fn = _fu.make_update_fn(self.method)
        if fn is None:
            if not getattr(self, "_warned_fused_update", False):
                self._warned_fused_update = True
                log.warning(
                    "BIGDL_TPU_FUSED_UPDATE=1 but %s has no fused kernel "
                    "(supported: Adam/AdamW/SGD) — using the tree-map "
                    "update", type(self.method).__name__)
            return self.method.update
        return fn

    # ---------------------------------------------------------------- data
    def _place_batch(self, x, y):
        def place(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.asarray(a))
            return t.to(self.device, non_blocking=True)
        return place(x), place(y)

    def _trees(self) -> Tuple[Tree, Dict]:
        """The model's trainable params tree, the model first moved to
        the trainer's device (and drawn from `seed` when it has no
        parameters yet)."""
        if next(self.model.parameters(), None) is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.model.init(gen, device=self.device)
        self.model.to(self.device)
        params = {k: p for k, p in self.model.named_parameters()
                  if p.requires_grad}
        return params, {}

    # -------------------------------------------------------------- optimize
    def optimize(self) -> Tuple[Tree, Dict]:
        """Run training to `end_when`; returns (params, model_state)."""
        if self.val_trigger is not None:
            raise NotImplementedError(
                "validation needs optim/metrics.py, which is not ported "
                "yet (ROADMAP, slice 2 leftovers)")
        self._nonfinite_run = 0
        params, model_state = self._trees()
        slots = self.slots if self.slots is not None \
            else self.method.init_slots(params)
        step = (self._make_step() if self.accum_steps == 1
                else self._make_accum_step(self.accum_steps))
        st = self.state
        # losses stay on the device until the log cadence: one host sync
        # per flush, not per step
        self._pending: List[tuple] = []
        self._window_t0 = time.time()
        self._window_records = 0

        while not self.end_when(st):
            epoch_start = time.time()
            epoch_records = 0
            ended_mid_epoch = False
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(st["epoch"])
            for x, y in self.dataset:
                xd, yd = self._place_batch(x, y)
                lr = self.method.current_lr(st)
                slots, loss = step(params, slots, xd, yd, as_lr(lr),
                                   st["neval"])
                n = xd.shape[0]
                st["neval"] += 1
                st["records"] += n
                st["batch_in_epoch"] = st.get("batch_in_epoch", 0) + 1
                epoch_records += n
                self._window_records += n
                self._pending.append((st["neval"], lr, loss))
                if st["neval"] % self._log_every == 0:
                    self._flush_metrics(st)
                if self.end_when(st):
                    ended_mid_epoch = True
                    break
            self._flush_metrics(st)
            if ended_mid_epoch:
                break
            st["epoch"] += 1
            st["batch_in_epoch"] = 0
            st["epoch_finished"] = True
            dur = time.time() - epoch_start
            log.info("epoch %d done: %d records in %.1fs (%.1f rec/s)",
                     st["epoch"] - 1, epoch_records, dur,
                     epoch_records / max(dur, 1e-9))
            st["epoch_finished"] = False

        self._flush_metrics(st)
        self.slots = slots
        self.params = {k: p.detach() for k, p in params.items()}
        self.model_state = model_state
        return self.params, model_state

    def _flush_metrics(self, st):
        """Fetch the pending device losses (one host sync), count
        non-finite steps and abort after BIGDL_TPU_MAX_NONFINITE in a
        row, log the throughput line, feed the train summary."""
        pending = getattr(self, "_pending", None)
        if not pending:
            return
        dt = time.time() - self._window_t0
        rate = self._window_records / max(dt, 1e-9)
        losses = torch.stack([p[2] for p in pending]).float().cpu().tolist()
        last_iter, last_lr = pending[-1][0], pending[-1][1]
        st["loss"] = float(losses[-1])
        bad_run = self._nonfinite_run
        for (it_num, _, _), loss_f in zip(pending, losses):
            if np.isfinite(loss_f):
                bad_run = 0
                continue
            bad_run += 1
            if self._max_nonfinite and bad_run >= self._max_nonfinite:
                self._nonfinite_run = bad_run
                self._pending = []
                raise NonFiniteLossError(
                    f"non-finite loss at iteration {it_num} — {bad_run} "
                    f"consecutive non-finite steps (BIGDL_TPU_MAX_NONFINITE"
                    f"={self._max_nonfinite}); aborting instead of "
                    f"training on NaNs")
        self._nonfinite_run = bad_run
        log.info("epoch %d iter %d loss %.4f lr %.5f %.1f rec/s",
                 st["epoch"], last_iter, st["loss"], last_lr, rate)
        if self._summary is not None:
            for (neval, lr, _), loss_f in zip(pending, losses):
                self._summary.add_scalar("Loss", float(loss_f), neval)
                self._summary.add_scalar("LearningRate", lr, neval)
                self._summary.add_scalar("Throughput", rate, neval)
        self._pending = []
        self._window_t0 = time.time()
        self._window_records = 0
