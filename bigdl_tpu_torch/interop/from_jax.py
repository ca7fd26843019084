"""Load a reference `(params, state)` tree into a port module.

The reference keeps weights in nested dicts keyed by child name
(bigdl_tpu/core/module.py); the port's modules carry the same child and
parameter names (core/module.py), so loading is a walk that copies each
leaf onto the module at the same path. Leaves must be numpy arrays (or
anything `numpy.asarray` takes): this module never imports JAX, so a
caller holding JAX arrays converts first, e.g.
`jax.tree.map(numpy.asarray, params)`.

Weights keep the reference orientation (Linear is (in, out)), so nothing
is transposed. A QuantizedLinear's leaves (`weight_q`, `weight_scale`,
`bias`) go through `set_quantized`, which also makes the kernel's
transposed copy. No ported module keeps state yet, so a state tree must
hold no leaves.

`slots_from_jax` carries an optimizer's slot trees the same way
(`{"m": tree, "v": tree}` for Adam, `{"velocity": tree}` for SGD with
momentum) into the `{slot name: {dotted path: tensor}}` dicts the
port's OptimMethods and trainer take.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.quantized import QuantizedLinear
from bigdl_tpu_torch.utils.platform import resolve_device


def _tensor(leaf, device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def load_jax_tree(module: Module, params: Dict[str, Any],
                  state: Optional[Dict[str, Any]] = None,
                  device=None) -> Module:
    """Copy `params` onto `module` in place, by name, on `device`
    (default `cuda`). Raises KeyError for a tree key the module has no
    child for, and ValueError where a leaf's shape disagrees with the
    module's declaration or `state` holds a leaf. Returns the module."""
    dev = resolve_device(device)
    if _has_leaf(state or {}):
        raise ValueError("the ported modules keep no state; this state "
                         "tree holds leaves")
    _load(module, params, dev, "")
    return module


def tree_to_paths(tree: Dict[str, Any], device=None,
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested reference tree with numpy leaves as `{dotted path:
    tensor}` on `device` (default `cuda`), the keys of
    `named_parameters()`."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_to_paths(v, dev, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _tensor(v, dev)
    return out


def slots_from_jax(slots: Dict[str, Any], device=None
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optimizer's slot trees (numpy leaves) as `{slot name: {dotted
    path: tensor}}` on `device`. The reference's slot-less `()` becomes
    `{}`."""
    return {name: tree_to_paths(tree, device) for name, tree in
            (slots or {}).items()}


def _has_leaf(tree) -> bool:
    return any(_has_leaf(v) if isinstance(v, dict) else True
               for v in tree.values())


def _load(mod, params, dev, path):
    children = dict(mod.named_children())
    leaves = {k: v for k, v in params.items() if k not in children}
    for k in params:
        if k in children:
            _load(children[k], params[k], dev, f"{path}{k}.")
        elif isinstance(params[k], dict):
            raise KeyError(f"tree key {path}{k} has no child module on "
                           f"{type(mod).__name__}")
    if isinstance(mod, QuantizedLinear):
        mod.set_quantized(_tensor(leaves["weight_q"], dev),
                          _tensor(leaves["weight_scale"], dev),
                          _tensor(leaves["bias"], dev)
                          if "bias" in leaves else None)
    else:
        specs = mod.param_specs() if isinstance(mod, Module) else {}
        for k, leaf in leaves.items():
            t = _tensor(leaf, dev)
            if k in specs and tuple(t.shape) != tuple(specs[k].shape):
                raise ValueError(f"{path}{k}: tree leaf {tuple(t.shape)} vs "
                                 f"declared {tuple(specs[k].shape)}")
            mod.set_param(k, t)
