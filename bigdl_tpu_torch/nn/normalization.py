"""Normalization layers (counterpart of bigdl_tpu/nn/normalization.py):
RMSNorm, which the LLaMA stack uses, and LayerNormalization, which the
pipelined LM's blocks and final norm use."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.core import init as initializers
from bigdl_tpu_torch.core.module import Module, ParamSpec


class RMSNorm(Module):
    """x / sqrt(mean(x^2) + eps) * weight over the last axis."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.hidden_size, self.eps = hidden_size, eps

    def param_specs(self):
        return {"weight": ParamSpec((self.hidden_size,), initializers.ones)}

    def forward(self, x):
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.reciprocal(torch.sqrt(var + self.eps)) * self.weight


def layer_norm(x, weight, bias, eps: float = 1e-6):
    """(x - mean) * 1/sqrt(var + eps) * weight + bias over the last axis,
    the biased variance, in the reference's order of operations."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps)) * weight + bias


class LayerNormalization(Module):
    """LayerNorm over the last axis with parameters `weight` (ones) and
    `bias` (zeros)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.hidden_size, self.eps = hidden_size, eps

    def param_specs(self):
        return {"weight": ParamSpec((self.hidden_size,), initializers.ones),
                "bias": ParamSpec((self.hidden_size,), initializers.zeros)}

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
