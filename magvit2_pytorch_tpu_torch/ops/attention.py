"""Attention modules on channels-last video (PyTorch counterpart of
``magvit2_pytorch_tpu/ops/attention.py``): full attention with learned memory
KV, its axial space/time wrappers, and Taylor-series linear attention.

Each module holds the reference's parameters and hands them to a kernel
wrapper (``ops/kernels``): the CUDA kernel on the card, its plain version on
the CPU. Only the slice's mode is ported: no cond, rotary positions,
dropout, masks or kv-cache streaming (ROADMAP.md queue A items 5, 9, 10).
"""

from __future__ import annotations

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import Linear
from magvit2_pytorch_tpu_torch.ops.kernels.axial_attention import (
    attention_block, time_attention_block)
from magvit2_pytorch_tpu_torch.ops.kernels.taylor_attention import (
    taylor_attention)
from magvit2_pytorch_tpu_torch.ops.norms import RMSNorm


class Attention(nn.Module):
    """Pre-norm multi-head attention with ``num_memory_kv`` learned key/values
    (reference magvit2_pytorch.py:327-388) on sequences ``(B, N, C)``.
    Parameters: ``norm.gamma``, ``to_qkv.0.weight``, ``mem_kv``,
    ``to_out.1.weight``."""

    def __init__(self, dim: int, dim_head: int = 32, heads: int = 8,
                 num_memory_kv: int = 4, causal: bool = False):
        super().__init__()
        assert num_memory_kv > 0
        dim_inner = dim_head * heads
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Sequential(Linear(dim, dim_inner * 3, bias=False))
        self.mem_kv = nn.Parameter(
            torch.empty(2, heads, num_memory_kv, dim_head))
        self.to_out = nn.Sequential(nn.Identity(),
                                    Linear(dim_inner, dim, bias=False))

    def init_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.mem_kv.copy_(torch.randn(self.mem_kv.shape, generator=gen))

    def block_params(self):
        return (self.norm.gamma, self.to_qkv[0].weight, self.mem_kv,
                self.to_out[1].weight)

    def forward(self, x):
        return attention_block(x, *self.block_params(), self.heads,
                               self.dim_head, self.causal)


class SpaceAttention(Attention):
    """Attention over the h*w pixels of each frame (reference
    magvit2_pytorch.py:444-454)."""

    def forward(self, x):
        *lead, h, w, c = x.shape
        seq = x.reshape(-1, h * w, c)
        return super().forward(seq).reshape(*lead, h, w, c)


class TimeAttention(Attention):
    """Attention over t for each pixel, causal in the layer stack (reference
    magvit2_pytorch.py:456-464). Runs on the ``(B, T, H*W, C)`` view: no
    transpose."""

    def __init__(self, *args, causal: bool = True, **kwargs):
        super().__init__(*args, causal=causal, **kwargs)

    def forward(self, x):
        b, t, h, w, c = x.shape
        out = time_attention_block(x.reshape(b, t, h * w, c),
                                   *self.block_params(), self.heads,
                                   self.dim_head, self.causal)
        return out.reshape(b, t, h, w, c)


class TaylorSeriesLinearAttn(nn.Module):
    """Second-order Taylor-softmax linear attention (the external
    ``taylor_series_linear_attention`` package the reference wraps,
    magvit2_pytorch.py:34,415-419). Parameters ``to_qkv.0.weight`` and
    ``to_out.1.weight``, no biases."""

    def __init__(self, dim: int, dim_head: int = 8, heads: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        dim_inner = dim_head * heads
        self.heads, self.dim_head, self.eps = heads, dim_head, eps
        self.to_qkv = nn.Sequential(Linear(dim, dim_inner * 3, bias=False))
        self.to_out = nn.Sequential(nn.Identity(),
                                    Linear(dim_inner, dim, bias=False))

    def forward(self, x, gamma):
        """x ``(B, N, C)``; ``gamma`` folds the preceding RMSNorm into the
        block (``attention.py:224-228``)."""
        return taylor_attention(x, gamma, self.to_qkv[0].weight,
                                self.to_out[1].weight, self.heads,
                                self.dim_head, self.eps)


class LinearAttention(nn.Module):
    """RMSNorm pre-norm around TaylorSeriesLinearAttn (reference
    magvit2_pytorch.py:390-430); the norm's gamma goes to the kernel."""

    def __init__(self, dim: int, dim_head: int = 8, heads: int = 8):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.attn = TaylorSeriesLinearAttn(dim, dim_head=dim_head, heads=heads)

    def forward(self, x):
        return self.attn(x, gamma=self.norm.gamma)


class LinearSpaceAttention(LinearAttention):
    """Linear attention over the h*w pixels of each frame (reference
    magvit2_pytorch.py:432-442)."""

    def forward(self, x):
        *lead, h, w, c = x.shape
        out = super().forward(x.reshape(-1, h * w, c))
        return out.reshape(*lead, h, w, c)
