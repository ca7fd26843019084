"""Attention (counterpart of bigdl_tpu/nn/attention.py): the dense
softmax attention, the online-softmax blockwise attention (the
reference's recompute for flash attention's backward; the port
recomputes densely, see kernels/flash_attention.py), the
bottom-right causal and padding masks, rotary embeddings,
MultiHeadAttention with GQA, RoPE and a callable `attn_impl` (the seam
kernels/flash_attention.FlashAttention plugs into), the sinusoidal
position signal, FeedForwardNetwork and the pre-norm TransformerLayer.
MultiHeadAttention's 'blockwise' attn_impl, TransformerLayer's
cross-attention and the cached/slot/paged decode helpers are not ported
yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core import init as initializers
from bigdl_tpu_torch.core.module import Module, ParamSpec
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNormalization

# the reference's finite mask fill (nn/attention.py NEG_INF): a fully
# masked row softmaxes to uniform weights instead of NaN
NEG_INF = -1e9


def dot_product_attention(q, k, v, mask=None, *, scale: Optional[float] = None):
    """softmax(q k^T * scale + mask) v over the last two dims.

    q: (..., Tq, d), k/v: (..., Tk, d); mask broadcastable to
    (..., Tq, Tk) with True = attend. The softmax runs in fp32."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                      dtype=logits.dtype,
                                                      device=logits.device))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def online_softmax_step(q, kb, vb, o, m, l, scale, pos_mask=None):
    """One online-softmax accumulation step over a KV block. Carries
    (o, m, l) in fp32; `pos_mask` broadcastable to the (..., Tq,
    Tk_block) logits, True = attend."""
    s = torch.matmul(q, kb.transpose(-1, -2)).float() * scale
    if pos_mask is not None:
        s = torch.where(pos_mask, s, torch.full((), NEG_INF, device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + torch.matmul(p.to(vb.dtype), vb).float()
    return o_new, m_new, l_new


def online_softmax_finish(o, l, dtype):
    """Normalize the accumulated output; fully-masked rows (l == 0)
    yield 0."""
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def blockwise_attention(q, k, v, *, block_size: int, causal: bool = False,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None):
    """Attention as a loop over KV blocks with an online softmax (max
    and sum carried in fp32), numerically dense attention up to
    summation order. Without autograd it holds one block's scores at a
    time, O(Tq * block); under autograd every block's are kept.

    q: (B, H, Tq, d), k/v: (B, H, Tk, d); Tk must divide by block_size.
    `q_offset` positions the queries within the key sequence for causal
    masking (default Tk - Tq: the queries are the LAST rows)."""
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if Tk % block_size != 0:
        raise ValueError(f"Tk={Tk} must divide by block_size={block_size}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q_offset is None:
        q_offset = Tk - Tq
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    o = torch.zeros((B, H, Tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    for start in range(0, Tk, block_size):
        pos_mask = None
        if causal:
            k_pos = start + torch.arange(block_size, device=q.device)
            pos_mask = q_pos[:, None] >= k_pos[None, :]
        o, m, l = online_softmax_step(
            q, k[:, :, start:start + block_size],
            v[:, :, start:start + block_size], o, m, l, scale, pos_mask)
    return online_softmax_finish(o, l, q.dtype)


def causal_mask(tq: int, tk: Optional[int] = None, device=None):
    """Lower-triangular (1, 1, Tq, Tk) bool mask. With tk > tq the
    queries sit at the END of the key sequence (bottom-right aligned,
    the KV-cache decode convention)."""
    tk = tk if tk is not None else tq
    q_pos = (tk - tq) + torch.arange(tq, device=device)
    k_pos = torch.arange(tk, device=device)
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def padding_mask(lengths, t: int):
    """(B, 1, 1, T) bool mask from per-row valid lengths."""
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths[:, None])[:, None, None, :]


def rotary_embedding(x, theta: float = 10000.0, positions=None):
    """Rotary position embedding, rotate-half convention (the head dim
    splits into two contiguous halves). x: (B, H, T, hd); `positions` is
    a (T,) vector shared by every row or a (B, T) matrix of per-row
    absolute positions (default 0..T-1)."""
    B, H, T, hd = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device, dtype=torch.int32)
    exponent = torch.arange(0, hd, 2, device=x.device,
                            dtype=torch.float32) / hd
    inv = 1.0 / (theta ** exponent)                           # (hd/2,)
    ang = positions[..., :, None] * inv                       # (..., T, hd/2)
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], -1)     # (..., T, hd)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], -1)
    if cos.ndim == 3:          # (B, T, hd) -> broadcast over the head dim
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


class MultiHeadAttention(Module):
    """Multi-head attention over (B, T, d_model) inputs with packed Q/K/V
    projections stored (d_model, n). `attn_impl` is 'dense' or a callable
    ``(q, k, v, mask=..., causal=...) -> out`` on (B, H, T, hd) tensors.
    `num_kv_heads` < num_heads is grouped-query attention: K/V heads are
    repeated up to the query heads (each kv head repeated in place,
    `repeat_interleave`, as `jnp.repeat` does) before the attend;
    `rope_theta` applies rotary embeddings to q and k."""

    def __init__(self, d_model: int, num_heads: int, *,
                 dropout: float = 0.0, attn_impl="dense", bias: bool = False,
                 num_kv_heads=None, rope_theta=None, name=None):
        super().__init__(name)
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % heads {num_heads} != 0")
        if attn_impl != "dense" and not callable(attn_impl):
            raise ValueError(
                f"attn_impl must be 'dense' or a callable "
                f"(q, k, v, mask=..., causal=...) -> out; got {attn_impl!r} "
                f"(the blockwise path is not ported yet)")
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} % num_kv_heads "
                             f"{num_kv_heads} != 0")
        self.d_model, self.num_heads = d_model, num_heads
        self.head_dim = d_model // num_heads
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.has_bias = bias
        self.num_kv_heads = num_kv_heads
        self.rope_theta = rope_theta

    def param_specs(self):
        d = self.d_model
        kv = (self.num_kv_heads or self.num_heads) * self.head_dim

        def spec(n):
            return ParamSpec((d, n), initializers.xavier, fan_in=d, fan_out=n)
        specs = {"wq": spec(d), "wk": spec(kv), "wv": spec(kv),
                 "wo": spec(d)}
        if self.has_bias:
            specs["bq"] = ParamSpec((d,), initializers.zeros)
            specs["bk"] = ParamSpec((kv,), initializers.zeros)
            specs["bv"] = ParamSpec((kv,), initializers.zeros)
            specs["bo"] = ParamSpec((d,), initializers.zeros)
        return specs

    def _split(self, x, heads=None):
        B, T, _ = x.shape
        return x.reshape(B, T, heads or self.num_heads,
                         self.head_dim).transpose(1, 2)

    def _attend(self, q, k, v, mask, causal):
        if callable(self.attn_impl):
            return self.attn_impl(q, k, v, mask=mask, causal=causal)
        if causal:
            cm = causal_mask(q.shape[2], k.shape[2], device=q.device)
            mask = cm if mask is None else ((mask != 0) & cm)
        return dot_product_attention(q, k, v, mask)

    def forward(self, x, memory=None, *, mask=None, causal: bool = False,
                positions=None):
        kv_src = memory if memory is not None else x
        q = x @ self.wq
        k = kv_src @ self.wk
        v = kv_src @ self.wv
        if self.has_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        kv_heads = self.num_kv_heads or self.num_heads
        q = self._split(q)
        k = self._split(k, kv_heads)
        v = self._split(v, kv_heads)
        if self.rope_theta:
            q = rotary_embedding(q, self.rope_theta, positions)
            k = rotary_embedding(k, self.rope_theta, positions)
        if kv_heads != self.num_heads:      # GQA: repeat kv to q heads
            rep = self.num_heads // kv_heads
            k = torch.repeat_interleave(k, rep, dim=1)
            v = torch.repeat_interleave(v, rep, dim=1)
        out = self._attend(q, k, v, mask, causal)
        B, H, T, hd = out.shape
        out = out.transpose(1, 2).reshape(B, T, H * hd)
        out = out @ self.wo
        if self.has_bias:
            out = out + self.bo
        return F.dropout(out, self.dropout, self.training)


def _ffn_relu(x):
    return torch.relu(x)


class FeedForwardNetwork(Module):
    """Position-wise FFN: Linear(d, d_ff) -> activation -> Linear(d_ff, d),
    children `w1` and `w2` with biases (the reference's FFN dropout is
    not ported; TransformerLayer refuses dropout in training)."""

    def __init__(self, d_model: int, d_ff: int, activation=_ffn_relu,
                 name=None):
        super().__init__(name)
        self.w1 = self.add_child("w1", Linear(d_model, d_ff))
        self.w2 = self.add_child("w2", Linear(d_ff, d_model))
        self.activation = activation

    def forward(self, x):
        return self.w2(self.activation(self.w1(x)))


class TransformerLayer(Module):
    """One pre-norm transformer block, x + attn(ln1(x)) then
    x + ffn(ln2(x)); children `ln1`, `attn` (dense, no biases), `ln2`,
    `ffn`. Self-attention only (the reference's `cross=True` decoder
    block, its other attention and FFN options and its cached decode
    steps are not ported yet); `dropout > 0` raises in training."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *,
                 dropout: float = 0.0, ln_eps: float = 1e-6, name=None):
        super().__init__(name)
        self.dropout = dropout
        self.ln1 = self.add_child("ln1", LayerNormalization(d_model,
                                                            eps=ln_eps))
        self.attn = self.add_child("attn", MultiHeadAttention(d_model,
                                                              num_heads))
        self.ln2 = self.add_child("ln2", LayerNormalization(d_model,
                                                            eps=ln_eps))
        self.ffn = self.add_child("ffn", FeedForwardNetwork(d_model, d_ff))

    def forward(self, x, *, mask=None, causal: bool = False):
        if self.training and self.dropout > 0.0:
            raise NotImplementedError(
                f"TransformerLayer dropout={self.dropout} in training is not "
                f"ported yet (ROADMAP Queue 1: dropout, whose RNG the port "
                f"does not reproduce)")
        x = x + self.attn(self.ln1(x), mask=mask, causal=causal)
        return x + self.ffn(self.ln2(x))


def positional_encoding_at(positions, d: int, dtype=torch.float32):
    """Sinusoidal signal at the given (T,) positions: sin then cos halves
    with frequencies exp(-ln(10000) * i / max(1, d//2 - 1)); an odd `d`
    gets a zero last column."""
    pos = positions.to(torch.float32)[:, None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, device=pos.device,
                                    dtype=torch.float32) / max(1, half - 1))
    angles = pos * freq[None, :]
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    if enc.shape[-1] < d:
        enc = F.pad(enc, (0, d - enc.shape[-1]))
    return enc.to(dtype)


def positional_encoding(t: int, d: int, dtype=torch.float32, device=None):
    """Sinusoidal position signal for positions 0..t-1, (t, d)."""
    return positional_encoding_at(torch.arange(t, device=device), d, dtype)
