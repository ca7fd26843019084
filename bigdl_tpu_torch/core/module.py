"""Module base over `torch.nn.Module` (counterpart of
bigdl_tpu/core/module.py).

The reference declares a module's parameters as `ParamSpec`s and keeps
their values in a separate nested `(params, state)` dict tree keyed by
child name. Here the values live on the module, but under the SAME
names: a child added as `add_child("l0", blk)` is the torch submodule
`l0`, and a spec named `"wq"` is the parameter `wq`. So
`model.state_dict()` keys are the reference tree's paths joined with
dots (`params["l0"]["attn"]["wq"]` <-> `"l0.attn.wq"`), and
interop/from_jax.py copies a reference tree in by name.

The reference's pure `apply(params, state, x, ...)` is the module call
`module(x, ...)`; its `training=` flag is the torch `train()`/`eval()`
mode (`module.training`), which the trainer sets. `torch.nn.Module.
apply(fn)` keeps its torch meaning. A params tree is the flat dict
`{dotted path: tensor}` of `named_parameters()`; `freeze()` marks a
subtree, and `trainable_mask` says per path whether the trainer may
move it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.core import init as initializers
from bigdl_tpu_torch.utils.platform import resolve_device


@dataclass
class ParamSpec:
    """Declaration of one trainable parameter."""
    shape: Tuple[int, ...]
    init: Callable = initializers.xavier
    dtype: torch.dtype = torch.float32
    fan_in: Optional[int] = None
    fan_out: Optional[int] = None


class Module(nn.Module):
    """Base class of the port's layers and containers.

    Subclasses declare parameters in :meth:`param_specs`, register
    children with :meth:`add_child` and implement `forward`. Parameters
    exist once :meth:`init` has drawn them (or interop/from_jax.py has
    copied them in)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__
        self._frozen = False

    def param_specs(self) -> Dict[str, ParamSpec]:
        return {}

    def add_child(self, name: str, module: "Module") -> "Module":
        self.add_module(name, module)
        return module

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Register (or replace) parameter `name`. Integer tensors (the
        int8 weights of a quantized layer) cannot carry gradients."""
        self.register_parameter(name, nn.Parameter(
            value, requires_grad=value.is_floating_point()))

    def freeze(self) -> "Module":
        """Mark this subtree non-trainable: the trainer restores its
        parameters after every update, so neither gradients, weight
        decay nor momentum move them."""
        self._frozen = True
        return self

    def unfreeze(self) -> "Module":
        for mod in self.modules():
            if isinstance(mod, Module):
                mod._frozen = False
        return self

    def trainable_mask(self, params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, bool]:
        """{path: bool} over `params` (default: every parameter): False
        where the parameter lies under a frozen module."""
        frozen = [name for name, mod in self.named_modules()
                  if getattr(mod, "_frozen", False)]
        keys = params.keys() if params is not None else \
            (k for k, _ in self.named_parameters())
        return {k: not any(f == "" or k.startswith(f + ".") for f in frozen)
                for k in keys}

    def init(self, generator: torch.Generator, device=None,
             dtype: Optional[torch.dtype] = None) -> "Module":
        """Draw every declared parameter of this tree from `generator`
        (pre-order: a module's own specs, then its children in the order
        they were added) and place it on `device` (default `cuda`).
        Returns self."""
        dev = resolve_device(device)
        for mod in self.modules():
            if not isinstance(mod, Module):
                continue
            for pname, spec in mod.param_specs().items():
                value = spec.init(generator, spec.shape, dtype or spec.dtype,
                                  fan_in=spec.fan_in, fan_out=spec.fan_out)
                mod.set_param(pname, value.to(dev))
        return self


class Criterion:
    """Loss contract: ``loss = criterion.forward(input, target)``, a
    scalar tensor; gradients come from autograd."""

    size_average: bool = True

    def forward(self, input, target):
        raise NotImplementedError

    def __call__(self, input, target):
        return self.forward(input, target)
