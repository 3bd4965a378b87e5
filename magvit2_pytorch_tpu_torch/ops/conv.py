"""Causal 3D convolution and the same-padded 2D conv (PyTorch counterpart
of the plain paths of ``magvit2_pytorch_tpu/ops/conv.py:CausalConv3d`` and
``SameConv2d``).

Activations are channels-last ``(B, T, H, W, C)``. A convolution permutes to
the ``(B, C, T, H, W)`` view — for a contiguous channels-last tensor that view
is exactly PyTorch's ``channels_last_3d`` layout, so no copy is made — runs
``F.conv3d`` and permutes back. Only the plain path is ported: stride 1, no
dilation; the JAX package's int8, lane-packed, w-pair and space-to-depth
lowerings are TPU layout tricks with the same numbers.

Pad modes follow the JAX package (``conv.py:47-61``, ``:481-508``): zeros
fold into the conv; ``reflect``, ``replicate`` and ``circular`` pad
explicitly ahead of a VALID conv. Two of its rules carry over with them:
a clip with no more frames than the causal pad is padded with zeros
whatever the mode (reference magvit2_pytorch.py:925), and a conv whose
``C_in * kt <= 32`` (the JAX package unfolds its time taps into channels
there) pads only time with the mode and h, w with zeros.
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


# torch's names for the pad modes of the JAX package (``conv.py:47-53``,
# where 'replicate' is jnp's 'edge' and 'circular' is 'wrap')
ZERO_PAD_MODES = ('constant', 'zeros')
PAD_MODES = (*ZERO_PAD_MODES, 'reflect', 'replicate', 'circular')
# the JAX package's tiny-C_in unfold bound (``conv.py:481-482``)
UNFOLD_MAX_TAPS_X_CHANNELS = 32


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
    """Time-causal 3D conv on ``(B, T, H, W, C)``: ``kt - 1`` frames in
    front, ``kh // 2`` and ``kw // 2`` pixels each side, padded with
    ``pad_mode`` (reference magvit2_pytorch.py:892-928; the module
    docstring gives the JAX package's two exceptions)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size,
                 pad_mode: str = 'constant'):
        super().__init__()
        if pad_mode not in PAD_MODES:
            raise ValueError(f'pad_mode={pad_mode!r}: one of {PAD_MODES}')
        kt, kh, kw = cast_tuple(kernel_size, 3)
        assert kh % 2 == 1 and kw % 2 == 1
        self.kernel_size = (kt, kh, kw)
        self.pad_mode = pad_mode
        self.conv = ConvWeights(dim_in, dim_out, (kt, kh, kw))

    def _padding(self, frames: int):
        """The mode of the explicit pad (None: zeros, folded into the conv)
        for a clip of ``frames`` frames, and whether h and w take it."""
        kt = self.kernel_size[0]
        mode = self.pad_mode
        if mode in ZERO_PAD_MODES or kt - 1 >= frames:
            return None, False
        c_in = self.conv.weight.shape[1]
        return mode, not (kt > 1 and c_in * kt <= UNFOLD_MAX_TAPS_X_CHANNELS)

    def forward(self, x):
        kt, kh, kw = self.kernel_size
        hp, wp = kh // 2, kw // 2
        if x.shape[1] == 0:
            # no frames in, none out (the rest of a one-frame clip under
            # separate first-frame encoding); F.conv3d refuses the empty clip
            return x.new_zeros(*x.shape[:4], self.conv.weight.shape[0])
        mode, pad_hw = self._padding(x.shape[1])
        if mode is None:
            x = to_channels_first(pad_time_front(x, kt - 1))
            padding = (0, hp, wp)
        else:
            x = to_channels_first(x)
            hw = (wp, wp, hp, hp) if pad_hw else (0, 0, 0, 0)
            x = F.pad(x, (*hw, kt - 1, 0), mode=mode)
            padding = (0, 0, 0) if pad_hw else (0, hp, wp)
        out = F.conv3d(x, self.conv.weight.to(x.dtype),
                       self.conv.bias.to(x.dtype), padding=padding)
        return to_channels_last(out)


class SameConv2d(nn.Module):
    """Same-padded 2D conv on ``(B, H, W, C)`` with zero padding and torch's
    default init (reference SameConv2d, magvit2_pytorch.py:887-890; the JAX
    package's ``ops/conv.py:658-682``). Its ``weight (out, in, kh, kw)``
    and ``bias`` sit at the module's own name, as in the reference."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size):
        super().__init__()
        kh, kw = cast_tuple(kernel_size, 2)
        assert kh % 2 == 1 and kw % 2 == 1
        self.kernel_size = (kh, kw)
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, kh, kw))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def init_parameters(self, gen: torch.Generator):
        fan_in = self.weight.shape[1] * math.prod(self.kernel_size)
        torch_default_init_(self.weight, self.bias, fan_in, gen)

    def forward(self, x):
        kh, kw = self.kernel_size
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                       self.bias.to(x.dtype), padding=(kh // 2, kw // 2))
        return out.permute(0, 2, 3, 1).contiguous()
