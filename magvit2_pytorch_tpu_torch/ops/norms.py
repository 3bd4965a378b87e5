"""Normalization layers (PyTorch counterpart of
``magvit2_pytorch_tpu/ops/norms.py``). Channels-last: the normalized axis is
always the trailing channel axis."""

from __future__ import annotations

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.utils.helpers import l2norm


class RMSNorm(nn.Module):
    """``F.normalize(x, dim=channel) * sqrt(dim) * gamma`` (reference
    magvit2_pytorch.py:258-276): the normalisation runs in float32 and is
    cast back before the gamma multiply, as in the JAX package."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        out32 = l2norm(x.float()) * (self.dim ** 0.5)
        return out32.to(x.dtype) * self.gamma.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis with learned scale and bias, eps 1e-5:
    the reference's final encoder norm (magvit2_pytorch.py:1322-1326)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return out * self.weight.to(x.dtype) + self.bias.to(x.dtype)
