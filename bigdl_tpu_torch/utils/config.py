"""Typed env-var knobs (counterpart of bigdl_tpu/utils/config.py), under
the same `BIGDL_TPU_*` names so one environment configures both
packages. Only the knobs the port reads so far are declared (serving,
and the local trainer's)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


@dataclass
class Knob:
    name: str                 # env var suffix
    default: Any
    parse: Callable
    doc: str

    @property
    def env(self) -> str:
        return f"BIGDL_TPU_{self.name}"

    def get(self):
        raw = os.environ.get(self.env)
        return self.default if raw is None else self.parse(raw)


_REGISTRY: Dict[str, Knob] = {}


def _register(name, default, parse, doc):
    _REGISTRY[name] = Knob(name, default, parse, doc)


_register("SERVE_MAX_BATCH", 256, int,
          "Online serving: the largest shape bucket (rows) the engine "
          "dispatches; buckets are powers of two capped here "
          "(serve/registry.py)")
_register("SERVE_MAX_WAIT_MS", 2.0, float,
          "Continuous batching deadline: a queued request older than "
          "this dispatches even if the batch is not full. 0 = greedy "
          "(serve/batcher.py)")
_register("SERVE_MAX_QUEUE_ROWS", 4096, int,
          "Admission control: queued rows above which submit sheds load "
          "with the typed Overloaded error; also the engine-wide cap on "
          "rows queued across all models (serve/batcher.py, "
          "serve/engine.py)")
_register("SERVE_INT8", False, _bool,
          "Serve registered models through the int8-quantized forward "
          "(nn/quantized.quantize at registration; QuantizedLinear runs "
          "the CUDA int8 GEMM on the card). Per-model override: "
          "ServeEngine.register(int8=...)")
_register("SERVE_MODEL_QUEUE_ROWS", "", str,
          "Per-model admission bounds: '' = every model takes "
          "SERVE_MAX_QUEUE_ROWS; a bare int applies to every model; "
          "'m1=512,m2=256' sets named models. register(max_queue_rows=) "
          "still wins (serve/engine.py)")
_register("SEED", 1, int,
          "Global default RNG seed for trainers: the Optimizer draws a "
          "model whose parameters do not exist yet from it (optim/local.py)")
_register("LOG_THROUGHPUT_EVERY", 20, int,
          "Iterations between trainer log lines; the losses of those "
          "iterations are fetched from the device together then")
_register("STEPS_PER_CALL", 1, int,
          "Optimizer steps per dispatch. Only 1 is ported: the K-step "
          "scan is an XLA dispatch device whose counterpart (CUDA graphs) "
          "is a ROADMAP item; K > 1 raises NotImplementedError")
_register("ACCUM_STEPS", 1, int,
          "Gradient accumulation: microbatches per optimizer step. M>1 "
          "splits each batch into M microbatches, averages their "
          "gradients and applies ONE update (optim/local.py)")
_register("MAX_NONFINITE", 3, int,
          "Abort training (NonFiniteLossError) after this many "
          "CONSECUTIVE non-finite training steps; 0 disables the abort "
          "(optim/local.py)")
_register("FUSED_UPDATE", "", str,
          "Run the optimizer update (Adam/AdamW/SGD) through the fused "
          "update (kernels/fused_update.py). '' / 0 (default) = off: the "
          "OptimMethod.update path stays the oracle. Anything else "
          "(1, or the reference's 'flat' / 'leaf') = on: the one-launch "
          "CUDA kernel over the leaf list for CUDA tensors, its plain "
          "version for CPU tensors. Unsupported methods log once and "
          "keep OptimMethod.update")


def get(name: str):
    """config.get('SERVE_MAX_BATCH') — typed, env-overridable."""
    return _REGISTRY[name].get()
