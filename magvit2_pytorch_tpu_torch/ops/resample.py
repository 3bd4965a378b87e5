"""Space/time down- and up-sampling and the residual units, plain and
conditioned (PyTorch counterpart of ``magvit2_pytorch_tpu/ops/resample.py``).

The downsamplers keep the reference's per-frame ``Conv2d`` and per-pixel
``Conv1d`` weights and run them as one 3D conv with a ``(1, k, k)`` or
``(k, 1, 1)`` kernel. The upsamplers are a 1x1 projection to ``4 * dim_out``
(``2 * dim_out``) channels in the reference's ``(c, p1, p2)`` (``(c, p)``)
order, then depth-to-space and SiLU; their weights start replicated, so the
layer starts as a nearest-neighbour upsampler (magvit2_pytorch.py:829-836).

Of these only ``TimeDownsample2x`` and the units' causal convs look at
earlier frames, so only they take a stream's ``state``
(``models/streaming.py``).

int8 (``MAGVIT2_TPU_INT8_CONV=1``, ``ops/conv.py`` ``int8_call``): the
spatial downsampler is a calibrated site (``resample.py:73-101`` of the JAX
package, which records its input's absmax whatever the percentile), the
spatial upsampler a dynamic one (``:216-227``: its weight scale is per
``dim_out`` channel, over the four positions and the input channels, and
its position-dependent bias comes after the dequantize), and the unfused
units' causal conv and 1x1 are sites of their own; under ``lane_pack``
with ``MAGVIT2_TPU_INT8_PACKED=1`` the stem units' causal conv is one too
(``CausalConv3d(w_blocked=True)``). The fused units (B4, B5) run in the
working dtype, as the JAX package's fused units do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import (
    Linear, SqueezeExcite, uniform_)
from magvit2_pytorch_tpu_torch.ops.conv import (
    CausalConv3d, Conv3DMod, ConvWeights, carried_frames, int8_call,
    pad_time_front, pointwise_5d, to_channels_first, to_channels_last)
from magvit2_pytorch_tpu_torch.ops.kernels import residual_unit as ru_kernels


class SpatialDownsample2x(nn.Module):
    """Stride-2 3x3 conv over (h, w), per frame (reference
    magvit2_pytorch.py:757-780)."""

    def __init__(self, dim: int, dim_out: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = ConvWeights(dim, dim_out, (kernel_size, kernel_size))

    def forward(self, x):
        k = self.kernel_size
        out = int8_call(self, x, self.conv.weight, self.conv.bias, 'absmax',
                        lambda w: w.unsqueeze(2), stride=2)
        if out is not None:
            return out
        out = F.conv3d(to_channels_first(x),
                       self.conv.weight.to(x.dtype).unsqueeze(2),
                       self.conv.bias.to(x.dtype),
                       stride=(1, 2, 2), padding=(0, k // 2, k // 2))
        return to_channels_last(out)


class TimeDownsample2x(nn.Module):
    """Causal pad ``k - 1`` frames, stride-2 conv over t, per pixel
    (reference magvit2_pytorch.py:782-807). Streamed, the ``k - 1`` frames
    in front are the previous chunk's last ones; a chunk of an even number
    of frames keeps the stride's phase."""

    def __init__(self, dim: int, dim_out: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = ConvWeights(dim, dim_out, (kernel_size,))

    def forward(self, x, state: Optional[dict] = None):
        k = self.kernel_size
        if state is not None:
            x = to_channels_first(carried_frames(self, x, k - 1, state))
        else:
            x = to_channels_first(pad_time_front(x, k - 1))
        out = F.conv3d(x, self.conv.weight.to(x.dtype)[..., None, None],
                       self.conv.bias.to(x.dtype), stride=(2, 1, 1))
        return to_channels_last(out)


def _replicated_kaiming_init_(linear: Linear, replicate: int,
                              gen: torch.Generator):
    """Kaiming-uniform (a=0) base weight ``(dim_out, dim_in)``, each row
    repeated ``replicate`` times (row ``c * replicate + r`` = base row ``c``);
    zero bias (reference magvit2_pytorch.py:829-836, 866-872)."""
    total, dim_in = linear.weight.shape
    base = torch.empty(total // replicate, dim_in)
    uniform_(base, math.sqrt(2.0) * math.sqrt(3.0 / dim_in), gen)
    with torch.no_grad():
        linear.weight.copy_(base.repeat_interleave(replicate, dim=0))
        linear.bias.zero_()


class SpatialUpsample2x(nn.Module):
    """1x1 projection ``dim -> 4 * dim_out``, depth-to-space with p1 = p2 = 2,
    SiLU (reference magvit2_pytorch.py:811-846)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.dim_out = dim_out
        self.net = nn.Sequential(Linear(dim, dim_out * 4))

    def init_parameters(self, gen: torch.Generator):
        _replicated_kaiming_init_(self.net[0], 4, gen)

    def project(self, x):
        """The projection and depth-to-space, before the SiLU."""
        proj = self.net[0]
        y = int8_call(self, x, proj.weight, proj.bias, None, pointwise_5d,
                      column_groups=4, depth_to_space=True)
        if y is not None:
            return y
        b, t, h, w, _ = x.shape
        y = proj(x).reshape(b, t, h, w, self.dim_out, 2, 2)
        return y.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, t, h * 2, w * 2,
                                                       self.dim_out)

    def forward(self, x):
        return F.silu(self.project(x))


class TimeUpsample2x(nn.Module):
    """1x1 projection ``dim -> 2 * dim_out``, depth-to-time with p = 2, SiLU
    (reference magvit2_pytorch.py:848-883)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.dim_out = dim_out
        self.net = nn.Sequential(Linear(dim, dim_out * 2))

    def init_parameters(self, gen: torch.Generator):
        _replicated_kaiming_init_(self.net[0], 2, gen)

    def forward(self, x):
        b, t, h, w, _ = x.shape
        y = self.net(x).reshape(b, t, h, w, self.dim_out, 2)
        y = y.permute(0, 1, 5, 2, 3, 4).reshape(b, t * 2, h, w, self.dim_out)
        return F.silu(y)


class ResidualUnit(nn.Module):
    """``x + SE(elu(conv1x1(elu(causal_conv(x)))))`` (reference
    magvit2_pytorch.py:930-944) under the reference's ``fn.{0,2,4}`` names.

    Dispatches as the JAX package's ``_ResidualUnitInner`` /
    ``_ResidualUnitOuter`` do (``resample.py:270-361``): the fused kernel B4
    for a channel count listed in ``MAGVIT2_TPU_FUSED_RU_WIDE_DIMS``, B5 for
    the units of the lane-packed stem (``w_blocked``), else the unfused
    modules. A fused call includes the ``+ x``."""

    def __init__(self, dim: int, kernel_size, pad_mode: str = 'constant'):
        super().__init__()
        self.dim = dim
        self.kernel_size = kernel_size
        self.pad_mode = pad_mode
        self.fn = nn.Sequential(
            CausalConv3d(dim, dim, kernel_size, pad_mode=pad_mode),
            nn.ELU(),
            Linear(dim, dim, int8_site=True),
            nn.ELU(),
            SqueezeExcite(dim),
        )

    def _fused_params(self):
        """The unit's ten tensors in ``residual_unit_ref``'s order."""
        conv, _, pw, _, se = self.fn
        return (conv.conv.weight, conv.conv.bias, pw.weight, pw.bias,
                se.to_k.weight, se.to_k.bias, se.net[0].weight,
                se.net[0].bias, se.net[2].weight, se.net[2].bias)

    def forward(self, x, w_blocked: bool = False,
                state: Optional[dict] = None):
        streaming = state is not None
        if not w_blocked and ru_kernels.wide_eligible(
                x, self.dim, self.kernel_size, self.pad_mode, streaming):
            return ru_kernels.fused_residual_unit_wide(
                x, *self._fused_params())
        if ru_kernels.fused_eligible(x, self.dim, self.kernel_size,
                                     w_blocked, self.pad_mode, streaming):
            # activations stay unpacked in the port
            return ru_kernels.fused_residual_unit(
                x, *self._fused_params(), packed_io=False)
        conv, *rest = self.fn
        y = conv(x, state=state, w_blocked=w_blocked)
        for module in rest:
            y = module(y)
        return y + x


class ResidualUnitMod(nn.Module):
    """The conditioned unit of ``cond_residual``: ``x + elu(conv1x1(elu(
    Conv3DMod(x, to_cond(cond)))))`` (reference magvit2_pytorch.py:946-988;
    the JAX package's ``ops/resample.py:364``). No kernel takes it."""

    def __init__(self, dim: int, kernel_size, dim_cond: int,
                 pad_mode: str = 'constant', demod: bool = True):
        super().__init__()
        kt, kh, kw = (kernel_size if isinstance(kernel_size, tuple)
                      else (kernel_size,) * 3)
        assert kh == kw
        self.to_cond = Linear(dim_cond, dim)
        self.conv = Conv3DMod(dim, spatial_kernel=kh, time_kernel=kt,
                              causal=True, demod=demod, pad_mode=pad_mode)
        self.conv_out = Linear(dim, dim, int8_site=True)

    def forward(self, x, cond, state: Optional[dict] = None):
        y = F.elu(self.conv(x, self.to_cond(cond), state=state))
        return F.elu(self.conv_out(y)) + x
