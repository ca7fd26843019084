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

The pipelined LM's reference state packs each pipeline stage's
parameters into one zero-padded fp32 row of `pv["flat"]` (S, L), in the
order `jax.tree.flatten` visits the stage's tree: dict keys sorted at
every level, so `b0, b1, b10, b11, b2, ...`, then `attn, ffn, ln1, ln2`,
then `wk, wo, wq, wv` and `bias, weight`. `flat_layout` gives that order
from a port stage, `rows_to_paths` unpacks rows by it and `paths_to_rows`
packs the port's parameters back into rows; `load_pipelined_lm` carries
a whole reference state and its optimizer slots (`(slot trees, step)`
from the reference's `init_update_slots`) into a port PipelinedLM, and
`pipelined_lm_state` is the inverse.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def flat_layout(stage: Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of a stage's declared parameters in the order the
    reference packs them into its flat row: sorted by the path's keys,
    level by level (jax.tree.flatten's order for nested dicts)."""
    out = []
    for mname, mod in stage.named_modules():
        if isinstance(mod, Module):
            for pname, spec in mod.param_specs().items():
                out.append((f"{mname}.{pname}" if mname else pname,
                            tuple(spec.shape)))
    return sorted(out, key=lambda e: tuple(e[0].split(".")))


def rows_to_paths(pipe, flat, device=None) -> Dict[str, torch.Tensor]:
    """Unpack the reference's (S, L) rows into `{"s{i}.<path>": tensor}`,
    the pipeline's `named_parameters()` keys, on `device`."""
    dev = resolve_device(device)
    flat = np.asarray(flat)
    if flat.shape[0] != pipe.n_stages:
        raise ValueError(f"{flat.shape[0]} rows for {pipe.n_stages} stages")
    out = {}
    for i, stage in enumerate(pipe.stages):
        off = 0
        for path, shape in flat_layout(stage):
            size = int(np.prod(shape)) if shape else 1
            if off + size > flat.shape[1]:
                raise ValueError(f"row {i} holds {flat.shape[1]} values; "
                                 f"stage {i}'s parameters need more")
            out[f"s{i}.{path}"] = _tensor(
                flat[i, off:off + size].reshape(shape), dev)
            off += size
    return out


def paths_to_rows(pipe, tree: Optional[Dict[str, torch.Tensor]] = None
                  ) -> np.ndarray:
    """Pack `{"s{i}.<path>": tensor}` (default: the pipeline's own
    parameters) into the reference's (S, L) fp32 rows, each zero-padded
    to the widest stage."""
    if tree is None:
        tree = {k: p.detach() for k, p in pipe.named_parameters()}
    rows = [np.concatenate(
        [tree[f"s{i}.{path}"].detach().cpu().numpy().astype(
            np.float32).ravel() for path, _ in flat_layout(stage)]
        or [np.zeros(0, np.float32)])
        for i, stage in enumerate(pipe.stages)]
    width = max(r.size for r in rows) or 1
    return np.stack([np.pad(r, (0, width - r.size)) for r in rows])


def _lm_paths(lm, tree, dev) -> Dict[str, torch.Tensor]:
    """A reference {"emb", "ln", "flat"} tree as the port's paths."""
    out = {"emb": _tensor(tree["emb"], dev)}
    out.update(tree_to_paths({"ln": tree["ln"]}, dev))
    out.update({f"pipe.{k}": v
                for k, v in rows_to_paths(lm.pipe, tree["flat"],
                                          dev).items()})
    return out


def load_pipelined_lm(lm, state: Dict[str, Any], slots=None, device=None):
    """Copy a reference PipelinedLM state `{"emb", "ln", "pv": {"flat",
    "state"}}` (numpy leaves) into the port's `lm`, in place, on `device`
    (default `cuda`). With the reference's `slots = (slot trees over
    {"emb", "ln", "flat"}, step)` returns the port's `(slot trees over
    lm.param_tree() paths, step)` for PipelinedLM.train_step; else
    None."""
    dev = resolve_device(device)
    if np.any(np.asarray(state["pv"].get("state", 0))):
        raise ValueError("the ported stages keep no state; this pipeline "
                         "state row is not zero")
    tree = {"emb": state["emb"], "ln": state["ln"],
            "flat": state["pv"]["flat"]}
    for path, t in _lm_paths(lm, tree, dev).items():
        mod_path, _, leaf = path.rpartition(".")
        mod = lm.get_submodule(mod_path) if mod_path else lm
        mod.set_param(leaf, t)
    if slots is None:
        return None
    inner, step = slots
    return ({name: _lm_paths(lm, t, dev) for name, t in
             (inner or {}).items()}, int(step))


def pipelined_lm_state(lm) -> Dict[str, Any]:
    """The inverse of load_pipelined_lm's parameter half: the port's
    parameters as the reference's `{"emb", "ln", "pv": {"flat"}}` with
    numpy leaves."""
    def np_(t):
        return t.detach().cpu().numpy()
    return {"emb": np_(lm.emb),
            "ln": {"bias": np_(lm.ln.bias), "weight": np_(lm.ln.weight)},
            "pv": {"flat": paths_to_rows(lm.pipe)}}
