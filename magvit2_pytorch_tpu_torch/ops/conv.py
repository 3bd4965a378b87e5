"""Causal 3D convolution, the same-padded and the strided 2D convs, the
time-strided transpose conv, the StyleGAN2-modulated conv and the blur
filter (PyTorch counterpart of the plain paths of
``magvit2_pytorch_tpu/ops/conv.py:CausalConv3d``, ``SameConv2d``,
``Conv2d``, ``CausalConvTranspose3d``, ``Conv3DMod`` and ``blur``).

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

Streaming (``models/streaming.py``): ``CausalConv3d`` and ``Conv3DMod`` take
a ``state`` dict keyed by module. The frames in front of a chunk are then
the last ``kt - 1`` frames of the previous chunk (zeros for the first) in
place of the causal pad, so chunked calls compute what one whole-clip call
does. That needs zero padding: the zero first state is the causal pad.
"""

from __future__ import annotations

import math
from typing import Optional

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


def carried_frames(module, x, frames: int, state: dict,
                   pad_mode: str = 'constant'):
    """A chunk with the ``frames`` frames the stream carries for ``module``
    in front (zeros before the first chunk); the new carry, the chunk's last
    ``frames`` frames of that, goes back into ``state``."""
    if pad_mode not in ZERO_PAD_MODES:
        raise ValueError(f'streaming needs zero padding (the zero first '
                         f'state is the causal pad), not {pad_mode!r}')
    front = state.get(module)
    if front is None:
        front = x.new_zeros(x.shape[0], frames, *x.shape[2:])
    x = torch.cat((front, x), dim=1)
    state[module] = x[:, x.shape[1] - frames:].clone()
    return x


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

    def forward(self, x, state: Optional[dict] = None):
        kt, kh, kw = self.kernel_size
        hp, wp = kh // 2, kw // 2
        if x.shape[1] == 0:
            # no frames in, none out (the rest of a one-frame clip under
            # separate first-frame encoding); F.conv3d refuses the empty clip
            return x.new_zeros(*x.shape[:4], self.conv.weight.shape[0])
        mode, pad_hw = self._padding(x.shape[1])
        if state is not None and kt > 1:
            x = to_channels_first(carried_frames(self, x, kt - 1, state,
                                                 self.pad_mode))
            padding = (0, hp, wp)
        elif mode is None:
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


class Conv2d(nn.Module):
    """Strided 2D conv with symmetric zero padding on ``(B, H, W, C)``
    (the JAX package's ``ops/conv.py:685-708``; the discriminators' and
    VGG's conv), ``weight (out, in, kh, kw)`` and ``bias`` at the module's
    own name as ``nn.Conv2d`` keeps them, torch's default init. The weights
    are cast to the input's dtype at use."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        kh, kw = cast_tuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, kh, kw))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def init_parameters(self, gen: torch.Generator):
        fan_in = math.prod(self.weight.shape[1:])
        torch_default_init_(self.weight, self.bias, fan_in, gen)

    def forward(self, x):
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                       self.bias.to(x.dtype), stride=self.stride,
                       padding=self.padding)
        return out.permute(0, 2, 3, 1)


def blur(x, space_only: bool = False, time_only: bool = False):
    """The normalised binomial [1, 2, 1] / 4 filter along h and w (and t),
    replicate border (reference Blur, magvit2_pytorch.py:512-547; the JAX
    package's ``ops/conv.py:840-887``), on ``(B, T, H, W, C)`` video or
    ``(B, H, W, C)`` images, one axis after another; each pass sums in
    float32 and rounds once to the input's dtype."""
    assert not (space_only and time_only)
    is_images = x.ndim == 4
    if is_images:
        x = x[:, None]
    axes = ([] if time_only else [2, 3]) + ([] if space_only else [1])
    dt = x.dtype
    for axis in axes:
        n = x.shape[axis]
        xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                       dim=axis).float()
        x = ((xp.narrow(axis, 0, n) + xp.narrow(axis, 2, n)) * 0.25
             + xp.narrow(axis, 1, n) * 0.5).to(dt)
    return x[:, 0] if is_images else x


class CausalConvTranspose3d(nn.Module):
    """Time-strided transpose conv on ``(B, T, H, W, C)``, its output cut to
    ``T * time_stride`` frames (reference magvit2_pytorch.py:990-1024; the
    JAX package's ``ops/conv.py:713``, which exports it and whose tokenizer,
    like the reference's, does not use it). ``conv.weight`` is torch's
    ``(in, out, kt, kh, kw)``."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size,
                 time_stride: int = 2):
        super().__init__()
        kt, kh, kw = cast_tuple(kernel_size, 3)
        assert kh % 2 == 1 and kw % 2 == 1
        self.kernel_size, self.time_stride = (kt, kh, kw), time_stride
        self.conv = ConvTransposeWeights(dim_in, dim_out, (kt, kh, kw))

    def forward(self, x):
        kt, kh, kw = self.kernel_size
        t = x.shape[1]
        out = F.conv_transpose3d(
            to_channels_first(x), self.conv.weight.to(x.dtype),
            self.conv.bias.to(x.dtype), stride=(self.time_stride, 1, 1),
            padding=(0, kh // 2, kw // 2))
        return to_channels_last(out[:, :, :t * self.time_stride])


class ConvTransposeWeights(nn.Module):
    """A transpose conv's ``weight (in, out, *kernel)`` and ``bias (out,)``
    with torch's default init (fan-in ``out * prod(kernel)``)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_in, dim_out, *kernel_size))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def init_parameters(self, gen: torch.Generator):
        fan_in = self.weight.shape[1] * math.prod(self.weight.shape[2:])
        torch_default_init_(self.weight, self.bias, fan_in, gen)


class Conv3DMod(nn.Module):
    """StyleGAN2 weight modulation and demodulation (reference Conv3DMod,
    magvit2_pytorch.py:680-753; the JAX package's ``ops/conv.py:754``):
    sample b convolves with ``W * (cond_b + 1)`` over the input channels,
    each output channel's kernel divided by its l2 norm, as one grouped
    ``F.conv3d`` with ``groups = B`` (the reference's own lowering).
    ``weights (out, in, kt, k, k)``, kaiming-normal for SELU.

    Causal in time unless ``causal=False``; ``state`` streams it as
    ``CausalConv3d`` (``ops/conv.py:811`` of the JAX package)."""

    def __init__(self, dim: int, spatial_kernel: int, time_kernel: int,
                 causal: bool = True, dim_out: Optional[int] = None,
                 demod: bool = True, eps: float = 1e-8,
                 pad_mode: str = 'constant'):
        super().__init__()
        assert spatial_kernel % 2 == 1 and time_kernel % 2 == 1
        if pad_mode not in PAD_MODES:
            raise ValueError(f'pad_mode={pad_mode!r}: one of {PAD_MODES}')
        dim_out = dim if dim_out is None else dim_out
        self.dim, self.spatial_kernel, self.time_kernel = (
            dim, spatial_kernel, time_kernel)
        self.causal, self.demod, self.eps, self.pad_mode = (
            causal, demod, eps, pad_mode)
        self.weights = nn.Parameter(torch.empty(
            dim_out, dim, time_kernel, spatial_kernel, spatial_kernel))

    def init_parameters(self, gen: torch.Generator):
        fan_in = math.prod(self.weights.shape[1:])
        with torch.no_grad():
            self.weights.copy_(torch.randn(self.weights.shape, generator=gen)
                               * (0.75 / math.sqrt(fan_in)))

    def forward(self, fmap, cond, state: Optional[dict] = None):
        kt, sp = self.time_kernel, self.spatial_kernel // 2
        b, dtype = fmap.shape[0], fmap.dtype
        # (B, out, in, kt, k, k), rounded to the working dtype where the
        # JAX package rounds it; the demodulation's sum of squares in
        # float32
        w = self.weights.to(dtype)[None] * (
            cond.to(dtype)[:, None, :, None, None, None] + 1.0)
        if self.demod:
            sq = w.float().square().sum(dim=(2, 3, 4, 5), keepdim=True)
            w = w * torch.rsqrt(sq.clamp_min(self.eps)).to(dtype)
        front, back = (kt - 1, 0) if self.causal else (kt // 2, kt // 2)
        if state is not None and self.causal and kt > 1:
            fmap = carried_frames(self, fmap, kt - 1, state, self.pad_mode)
            front = 0
        x = to_channels_first(fmap)
        if self.pad_mode in ZERO_PAD_MODES:
            x = F.pad(x, (0, 0, 0, 0, front, back))
            padding = (0, sp, sp)
        else:
            x = F.pad(x, (sp, sp, sp, sp, front, back), mode=self.pad_mode)
            padding = (0, 0, 0)
        out = F.conv3d(x.reshape(1, -1, *x.shape[2:]),
                       w.reshape(-1, *w.shape[2:]), padding=padding,
                       groups=b)
        return to_channels_last(out.reshape(b, -1, *out.shape[2:]))
