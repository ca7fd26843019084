"""Pipelined Transformer LM (counterpart of bigdl_tpu/models/
pipelined_lm.py), trained on one device.

The embedding (tied with the softmax head) and the final LayerNorm live
outside the pipeline; the `num_layers` pre-norm causal blocks are grouped
into `n_stages` stages of parallel/pipeline.py's Pipeline, which runs
them microbatch by microbatch and streams dL/dx back out for the
embedding. With `fused_loss=True` the head's loss is the cut
cross-entropy (kernels/cut_cross_entropy.py): the (microbatch * T,
vocab) logits are never materialized, and on the card each microbatch
launches K3a forward and K3b and K3c backward.

Parameters: `emb` (vocab, d_model), `ln.{weight,bias}` and
`pipe.s{i}.b{j}.{ln1,attn,ln2,ffn}...`, the reference's state tree
`{"emb", "ln", "pv"}` with the flat rows unpacked per stage
(interop/from_jax.py carries one into the other). The reference's
`apply(tokens)` is the module call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core import init as initializers
from bigdl_tpu_torch.core.module import Module, ParamSpec
from bigdl_tpu_torch.kernels.cut_cross_entropy import cut_cross_entropy
from bigdl_tpu_torch.nn.attention import TransformerLayer, positional_encoding
from bigdl_tpu_torch.nn.normalization import LayerNormalization, layer_norm
from bigdl_tpu_torch.optim.method import apply_update
from bigdl_tpu_torch.parallel.pipeline import Pipeline
from bigdl_tpu_torch.utils.platform import resolve_device

# the cut cross-entropy's rows are padded to a multiple of its row block
FUSED_ROW_BLOCK = 128


class CausalBlocks(Module):
    """A pipeline stage: k pre-norm causal transformer blocks `b0`..."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, k: int,
                 dropout: float = 0.0, name=None):
        super().__init__(name)
        self.k = k
        for i in range(k):
            self.add_child(f"b{i}", TransformerLayer(
                d_model, num_heads, d_ff, dropout=dropout))

    def forward(self, x):
        for i in range(self.k):
            x = getattr(self, f"b{i}")(x, causal=True)
        return x


class PipelinedLM(Module):
    """Decoder-only LM with its block stack in a Pipeline.

        lm = PipelinedLM(vocab, n_stages=1, n_microbatches=4,
                         fused_loss=True, device="cuda")
        lm.init(torch.Generator().manual_seed(0))
        adam = Adam(3e-4)
        slots = init_update_slots(adam, lm.param_tree())
        loss, slots = lm.train_step(x, y, method=adam, slots=slots)
        logits = lm(x)
    """

    def __init__(self, vocab_size: int, d_model: int = 128,
                 num_heads: int = 4, d_ff: Optional[int] = None,
                 num_layers: int = 4, n_stages: int = 4,
                 n_microbatches: int = 8, max_len: int = 512,
                 fused_loss: bool = False, device=None, name=None):
        super().__init__(name)
        if num_layers % n_stages:
            raise ValueError(f"num_layers {num_layers} must divide by "
                             f"n_stages {n_stages}")
        self.device = resolve_device(device)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.max_len = max_len     # as the reference: the signal covers any T
        self.fused_loss = fused_loss
        d_ff = d_ff or 4 * d_model
        per = num_layers // n_stages
        self.pipe = self.add_child("pipe", Pipeline(
            [CausalBlocks(d_model, num_heads, d_ff, per)
             for _ in range(n_stages)], n_microbatches=n_microbatches))
        self.ln = self.add_child("ln", LayerNormalization(d_model))

    def param_specs(self):
        return {"emb": ParamSpec((self.vocab_size, self.d_model),
                                 initializers.random_normal(
                                     0.0, self.d_model ** -0.5))}

    def init(self, generator: torch.Generator, device=None,
             dtype: Optional[torch.dtype] = None) -> "PipelinedLM":
        """Draw every parameter from `generator` onto `device` (default:
        the model's device)."""
        return super().init(generator, device if device is not None
                            else self.device, dtype)

    def param_tree(self):
        """{path: parameter} of the whole model, the tree the update and
        its slots run over."""
        return {k: p.detach() for k, p in self.named_parameters()}

    # ------------------------------------------------------------ pieces
    def _tokens(self, a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(self.device, torch.long)

    def _embed(self, emb, tokens):
        x = F.embedding(tokens, emb) * math.sqrt(self.d_model)
        return x + positional_encoding(tokens.shape[1], self.d_model,
                                       x.dtype, device=x.device)

    def loss_fn(self):
        """`loss(h_mb, y_mb, lp)`: the final LayerNorm and the tied head's
        mean next-token loss over a microbatch, with lp = {"emb",
        "ln.weight", "ln.bias"}."""
        d, eps = self.d_model, self.ln.eps
        if self.fused_loss:
            def loss(h_mb, y_mb, lp):
                h = layer_norm(h_mb, lp["ln.weight"], lp["ln.bias"], eps)
                hf, yf = h.reshape(-1, d), y_mb.reshape(-1)
                n = hf.shape[0]
                pad = (-n) % FUSED_ROW_BLOCK
                if pad:
                    # padded rows are sliced off before the mean: their
                    # cotangent is zero and they add no gradient
                    hf, yf = F.pad(hf, (0, 0, 0, pad)), F.pad(yf, (0, pad))
                return cut_cross_entropy(hf, lp["emb"], yf)[:n].mean()
            return loss

        def loss(h_mb, y_mb, lp):
            h = layer_norm(h_mb, lp["ln.weight"], lp["ln.bias"], eps)
            logp = torch.log_softmax(h @ lp["emb"].T, dim=-1)
            return -torch.mean(torch.gather(logp, -1, y_mb[..., None]))
        return loss

    # ------------------------------------------------------------- steps
    def train_step(self, x_tokens, y_tokens, lr: float = 1e-3, method=None,
                   slots=None):
        """One step over (B, T) token ids (numpy or tensors). Plain SGD at
        `lr` returns the loss; with an OptimMethod `method` and `slots`
        from `optim.method.init_update_slots(method, lm.param_tree())`
        returns (loss, new slots), the method's own rate and step counter
        applying. The parameters are updated in place."""
        x, y = self._tokens(x_tokens), self._tokens(y_tokens)
        with torch.enable_grad():
            emb = self.emb.detach().requires_grad_()
            h = self._embed(emb, x)
            lp = {"emb": self.emb, "ln.weight": self.ln.weight,
                  "ln.bias": self.ln.bias}
            loss, g_stage, d_x, d_lp = self.pipe.train_step_full(
                h.detach(), y, self.loss_fn(), lp)
            (d_emb_in,) = torch.autograd.grad(h, emb, d_x)
        grads = {"emb": d_emb_in + d_lp["emb"],
                 "ln.weight": d_lp["ln.weight"], "ln.bias": d_lp["ln.bias"]}
        grads.update({f"pipe.{k}": g for k, g in g_stage.items()})
        params = self.param_tree()
        new_params, slots = apply_update(method, params, grads, slots,
                                         sgd_lr=lr)
        with torch.no_grad():
            for k, p in self.named_parameters():
                p.copy_(new_params[k])
        loss = float(loss)
        return loss if method is None else (loss, slots)

    def forward(self, tokens):
        """(B, T) token ids -> (B, T, vocab) logits."""
        tokens = self._tokens(tokens)
        h = self.pipe(self._embed(self.emb, tokens))
        return self.ln(h) @ self.emb.T
