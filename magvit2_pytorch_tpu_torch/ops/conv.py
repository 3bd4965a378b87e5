"""Causal 3D convolution, the same-padded and the strided 2D convs, the
time-strided transpose conv, the StyleGAN2-modulated conv and the blur
filter (PyTorch counterpart of the plain paths of
``magvit2_pytorch_tpu/ops/conv.py:CausalConv3d``, ``SameConv2d``,
``Conv2d``, ``CausalConvTranspose3d``, ``Conv3DMod`` and ``blur``).

Activations are channels-last ``(B, T, H, W, C)``. A convolution permutes to
the ``(B, C, T, H, W)`` view — for a contiguous channels-last tensor that view
is exactly PyTorch's ``channels_last_3d`` layout, so no copy is made — runs
``F.conv3d`` and permutes back. Stride 1, no dilation; the JAX package's
lane-packed, w-pair and space-to-depth lowerings are TPU layout tricks with
the same numbers and are not ported.

int8 inference (the JAX package's ``MAGVIT2_TPU_INT8_CONV=1``,
``conv.py:64-104``): ``int8_conv_enabled`` is its gate, read at every
call, and ``int8_call`` runs one int8 site on the kernels of
``ops/kernels/int8.py`` (K1 quantizes x per tensor, K2 convolves s8 x s8 ->
s32 and dequantizes). The sites are the JAX package's: ``CausalConv3d``
here, the units' 1x1 (``Linear(int8_site=True)``) and the spatial down- and
upsamplers (``ops/resample.py``). With ``MAGVIT2_TPU_INT8_PACKED=1`` the
causal conv of a lane-packed stem unit (``w_blocked``) is gated on the
packed layout's widths, 2 C_in and 2 C_out (``conv.py:392-403``); the
port's activations stay unpacked, and the int32 sums are the same: the
w-blocked kernel holds each tap once in each output phase and zeros
elsewhere, so its per-channel scales and int8 values are the unblocked
kernel's. A site is dynamic (x's absmax on every
call, the weight quantized once per weight version) unless the scope the
tokenizer opens (``int8_scope``) gives it a calibrated ``Int8Site``: its
static activation scale and pre-quantized weight (``VideoTokenizer.
calibrate_int8``). A stream runs in the working dtype (``streaming=True``).

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

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Callable, Optional

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


# -- int8 inference -----------------------------------------------------------

INT8_ENV = 'MAGVIT2_TPU_INT8_CONV'
INT8_PACKED_ENV = 'MAGVIT2_TPU_INT8_PACKED'
# the JAX package's gate: min(C_in, C_out) >= 128 (measured on v5e; the
# gate decides which sites quantize, so the port keeps it as it is)
INT8_MIN_CHANNELS = 128


def int8_conv_enabled(c_in: int = 128, c_out: int = 128) -> bool:
    """The JAX package's gate (``conv.py:77-83``): ``MAGVIT2_TPU_INT8_CONV=1``
    and ``min(c_in, c_out) >= 128``. The environment is read at every call,
    where the JAX package reads it at trace time (ROADMAP C5)."""
    return (os.environ.get(INT8_ENV, '') == '1'
            and min(c_in, c_out) >= INT8_MIN_CHANNELS)


def quantize_per_tensor(x, scale=None):
    """x -> ``(int8 x, float32 0-d scale)``, symmetric absmax, or with the
    given static ``scale`` (``conv.py:87-93``); K1 on the card."""
    from magvit2_pytorch_tpu_torch.ops.kernels import int8
    return int8.quantize_s8(x, scale)


def quantize_per_channel_out(kernel):
    """kernel ``(N, ...)`` -> ``(int8 kernel, float32 (N,) scales)``, one
    scale per output channel: dim 0 in the port's ``(out, in, ...)``
    layouts, where the JAX package (``conv.py:96-104``) takes its minor
    axis."""
    from magvit2_pytorch_tpu_torch.ops.kernels import int8
    k32 = kernel.float()
    scale = int8.scale_of(k32.abs().amax(dim=tuple(range(1, kernel.ndim))))
    q = int8.quantize_with(k32, scale.reshape(-1, *(1,) * (kernel.ndim - 1)))
    return q, scale


class Int8Site:
    """A calibrated site's static state, the JAX package's ``int8``
    collection entry: ``act_scale`` (float32 0-d), ``kernel_q`` (int8, in
    the site's parameter layout) and ``kernel_scale`` (float32 per output
    channel). The kernels' form of the weight is made once, at first use."""

    def __init__(self, act_scale, kernel_q, kernel_scale):
        self.act_scale = act_scale
        self.kernel_q = kernel_q
        self.kernel_scale = kernel_scale
        self._weight = None

    def int8_weight(self, as_5d: Callable):
        from magvit2_pytorch_tpu_torch.ops.kernels import int8
        if self._weight is None:
            self._weight = int8.int8_weight(as_5d(self.kernel_q),
                                            self.kernel_scale)
        return self._weight

    def to(self, device):
        return Int8Site(*(t.to(device) for t in (
            self.act_scale, self.kernel_q, self.kernel_scale)))


@dataclasses.dataclass
class Int8Scope:
    """What the int8 sites of one call see: ``sites`` (module -> its
    ``Int8Site``; a site without one is dynamic), ``record`` (module -> the
    largest statistic of its input so far, during ``calibrate_int8``) with
    ``percentile``, and ``streaming`` (every site runs in the working
    dtype)."""
    sites: dict = dataclasses.field(default_factory=dict)
    record: Optional[dict] = None
    percentile: Optional[float] = None
    streaming: bool = False


_INT8_SCOPE = contextvars.ContextVar('magvit2_int8_scope',
                                     default=Int8Scope())


@contextlib.contextmanager
def int8_scope(**kwargs):
    """The ``Int8Scope(**kwargs)`` of the int8 sites called inside."""
    token = _INT8_SCOPE.set(Int8Scope(**kwargs))
    try:
        yield
    finally:
        _INT8_SCOPE.reset(token)


def activation_stat(x, percentile: Optional[float] = None):
    """|x|'s largest value, or its ``percentile`` as ``jnp.percentile``
    (linear) computes it in float32 (``conv.py:403-413``)."""
    ax = x.float().abs().reshape(-1)
    if percentile is None:
        return ax.amax()
    one = torch.ones((), dtype=torch.float32, device=ax.device)
    # divided by a tensor, IEEE division on both devices (see scale_of)
    pos = (one * float(percentile)) / (one * 100.0) * (one * ax.numel() - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    top = ax.numel() - 1
    ordered = torch.sort(ax).values
    v_low = ordered[int(low.clamp(0, top).item())]
    v_high = ordered[int(high.clamp(0, top).item())]
    return v_low * w_low + v_high * w_high


def int8_call(module, x, weight, bias, stat: Optional[str],
              as_5d: Callable = lambda w: w, stride: int = 1,
              column_groups: int = 1, depth_to_space: bool = False,
              gate_widths: Optional[tuple] = None):
    """Run ``module``'s int8 site on x, or return None where the call runs
    in the working dtype (the gate is off, or a stream). ``weight (N, C,
    ...)`` in the parameter's layout (``as_5d`` views it as ``(N, C, kt,
    kh, kw)``), ``column_groups`` consecutive columns sharing one output
    channel's scale (the upsampler's 4 positions, which ``depth_to_space``
    hands the kernel position-major, ``(p1, p2, c)``). ``stat``: what a
    calibration records of x (``'percentile'``: the percentile when one is
    asked, else the absmax; ``'absmax'``; None: the site is not calibrated
    and stays dynamic). ``gate_widths``: the ``(C_in, C_out)`` the gate
    reads in place of the weight's (the packed stem's physical widths)."""
    c_out, c_in = weight.shape[0] // column_groups, weight.shape[1]
    scope = _INT8_SCOPE.get()
    if scope.streaming or not int8_conv_enabled(
            *(gate_widths or (c_in, c_out))):
        return None
    from magvit2_pytorch_tpu_torch.ops.kernels import int8
    if stat is not None and scope.record is not None:
        value = activation_stat(
            x, scope.percentile if stat == 'percentile' else None)
        prev = scope.record.get(module)
        scope.record[module] = (value if prev is None
                                else torch.maximum(prev, value))
    site = scope.sites.get(module) if stat is not None else None
    if site is not None:
        return int8.int8_conv(x, site.int8_weight(as_5d), bias, stride,
                              site.act_scale, depth_to_space)

    def by_position(t):
        """Columns (c, p) -> (p, c)."""
        if not depth_to_space:
            return t
        return t.reshape(c_out, column_groups, *t.shape[1:]).transpose(
            0, 1).reshape(t.shape)

    def quantized(w):
        q, scale = quantize_per_channel_out(
            w.reshape(c_out, column_groups, *w.shape[1:]))
        return int8.int8_weight(
            as_5d(by_position(q.reshape(w.shape))),
            by_position(scale.repeat_interleave(column_groups)))

    w8 = int8.cached_int8_weight(weight, x.dtype, quantized)
    return int8.int8_conv(x, w8, by_position(bias), stride, None,
                          depth_to_space)


def pointwise_5d(w):
    """A 1x1's ``(N, C)`` weight as ``(N, C, 1, 1, 1)``."""
    return w[:, :, None, None, None]


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

    def forward(self, x, state: Optional[dict] = None,
                w_blocked: bool = False):
        """``w_blocked``: the conv of a lane-packed stem unit, which the
        int8 gate reads at the packed widths under
        ``MAGVIT2_TPU_INT8_PACKED=1``."""
        kt, kh, kw = self.kernel_size
        hp, wp = kh // 2, kw // 2
        if x.shape[1] == 0:
            # no frames in, none out (the rest of a one-frame clip under
            # separate first-frame encoding); F.conv3d refuses the empty clip
            return x.new_zeros(*x.shape[:4], self.conv.weight.shape[0])
        if state is None and self.pad_mode in ZERO_PAD_MODES:
            # the JAX package's int8 gate (conv.py:389-403): not streaming,
            # zero pads, at the packed widths where asked; the kernel folds
            # the causal and spatial pads in
            widths = None
            if w_blocked and os.environ.get(INT8_PACKED_ENV, '') == '1':
                c_out, c_in = self.conv.weight.shape[:2]
                widths = (2 * c_in, 2 * c_out)
            out = int8_call(self, x, self.conv.weight, self.conv.bias,
                            'percentile', gate_widths=widths)
            if out is not None:
                return out
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
