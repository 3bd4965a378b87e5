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

    conditioned = False

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x, cond=None):
        """``cond`` is taken and ignored, so a module calls either norm as
        ``norm(x, cond)``."""
        out32 = l2norm(x.float()) * (self.dim ** 0.5)
        return out32.to(x.dtype) * self.gamma.to(x.dtype)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose gamma (and, with ``bias``, beta) is a ``Linear`` of a
    per-sample cond vector ``(B, dim_cond)``, broadcast over the middle axes
    of ``x`` (reference magvit2_pytorch.py:278-323; the JAX package's
    ``ops/norms.py:43``). The gamma projection starts at weight 0 and bias
    1, the beta one at 0 and 0, so the norm starts as a plain l2 norm."""

    conditioned = True

    def __init__(self, dim: int, dim_cond: int, bias: bool = False):
        super().__init__()
        # imported here: ops.basic imports this module
        from magvit2_pytorch_tpu_torch.ops.basic import Linear
        self.dim, self.dim_cond = dim, dim_cond
        self.to_gamma = Linear(dim_cond, dim)
        self.to_bias = Linear(dim_cond, dim) if bias else None

    def init_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.to_gamma.weight.zero_()
            self.to_gamma.bias.fill_(1.0)
            if self.to_bias is not None:
                self.to_bias.weight.zero_()
                self.to_bias.bias.zero_()

    def forward(self, x, cond=None):
        assert cond is not None, 'a conditioned norm needs cond'
        assert cond.shape == (x.shape[0], self.dim_cond), (
            f'cond {tuple(cond.shape)} for x {tuple(x.shape)}: expected '
            f'({x.shape[0]}, {self.dim_cond})')
        lead = (cond.shape[0],) + (1,) * (x.ndim - 2)
        out = (l2norm(x.float()) * (self.dim ** 0.5)).to(x.dtype)
        out = out * self.to_gamma(cond).to(x.dtype).reshape(*lead, self.dim)
        if self.to_bias is not None:
            out = out + self.to_bias(cond).to(x.dtype).reshape(*lead,
                                                               self.dim)
        return out


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
