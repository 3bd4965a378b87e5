"""Causal 3D convolution (PyTorch counterpart of the plain path of
``magvit2_pytorch_tpu/ops/conv.py:CausalConv3d``).

Activations are channels-last ``(B, T, H, W, C)``. A convolution permutes to
the ``(B, C, T, H, W)`` view — for a contiguous channels-last tensor that view
is exactly PyTorch's ``channels_last_3d`` layout, so no copy is made — runs
``F.conv3d`` and permutes back. Only the plain path is ported: zero padding,
stride 1, no dilation; the JAX package's int8, lane-packed, w-pair and
space-to-depth lowerings are TPU layout tricks with the same numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import torch_default_init_
from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple


def to_channels_first(x):
    """``(B, T, H, W, C)`` -> the ``(B, C, T, H, W)`` view (no copy)."""
    return x.permute(0, 4, 1, 2, 3)


def to_channels_last(x):
    """``(B, C, T, H, W)`` -> contiguous ``(B, T, H, W, C)``; free when ``x``
    is already in ``channels_last_3d`` memory format."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def pad_time_front(x, frames: int):
    """Zero frames in front of a channels-last video (the causal pad)."""
    if frames == 0:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, 0, frames, 0))


class ConvWeights(nn.Module):
    """A conv's ``weight (out, in, *kernel)`` and ``bias (out,)`` under the
    reference's ``.conv`` name, with torch's default init."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, *kernel_size))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def init_parameters(self, gen: torch.Generator):
        fan_in = self.weight.shape[1] * math.prod(self.weight.shape[2:])
        torch_default_init_(self.weight, self.bias, fan_in, gen)


class CausalConv3d(nn.Module):
    """Time-causal 3D conv on ``(B, T, H, W, C)``: ``kt - 1`` zero frames in
    front, ``kh // 2`` and ``kw // 2`` zero pixels each side (reference
    magvit2_pytorch.py:892-928)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size,
                 pad_mode: str = 'constant'):
        super().__init__()
        if pad_mode not in ('constant', 'zeros'):
            raise NotImplementedError(
                f'pad_mode={pad_mode!r}: the port pads with zeros only '
                '(ROADMAP.md queue A item 3)')
        kt, kh, kw = cast_tuple(kernel_size, 3)
        assert kh % 2 == 1 and kw % 2 == 1
        self.kernel_size = (kt, kh, kw)
        self.conv = ConvWeights(dim_in, dim_out, (kt, kh, kw))

    def forward(self, x):
        kt, kh, kw = self.kernel_size
        x = to_channels_first(pad_time_front(x, kt - 1))
        out = F.conv3d(x, self.conv.weight.to(x.dtype),
                       self.conv.bias.to(x.dtype), padding=(0, kh // 2, kw // 2))
        return to_channels_last(out)
