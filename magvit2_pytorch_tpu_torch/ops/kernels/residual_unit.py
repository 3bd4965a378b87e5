"""Fused ResidualUnit: causal 3x3x3 conv -> ELU -> 1x1 -> ELU ->
SqueezeExcite -> +x in one call (reference magvit2_pytorch.py:930-944).

Replaces two TPU kernels:
- ``magvit2_pytorch_tpu/ops/pallas/residual_unit_wide.py`` ``_kernel``
  (``fused_residual_unit_wide``, :249): the unit on the native
  ``(B, T, H, W, C)`` layout, entry ``fused_residual_unit_wide`` here;
- ``magvit2_pytorch_tpu/ops/pallas/residual_unit.py`` ``_kernel``
  (``fused_residual_unit``, :332): the same unit on the lane-packed
  ``(B, T, H, W/2, 2C)`` view of the 64-channel stem, entry
  ``fused_residual_unit`` here. The packed view is the same bytes as the
  unpacked one (``x_flat[h, w * C + c]`` is identical), and its pair-layout
  rings and structural zeros serve the TPU's 128-wide lanes only, so this
  entry reshapes to ``(B, T, H, W, C)`` and launches the same kernel.

What the unit computes, with the JAX kernel's cast points
(``residual_unit_wide.py:117-153``; T is the working dtype):

    y1 = ELU(T(T(conv(x)) + conv_b))                   conv sums in float32
    y2 = ELU(T(T(y1 pw^T) + pw_b))
    logit = float(T(T(y2 . k) + kb))                   per pixel
    attn = T(softmax over the frame's H*W logits)      in float32
    context = T(sum_pixels attn * y2)                  float32 sums
    g = leaky_relu_0.1(T(T(context gi^T) + gi_b))
    gates = sigmoid(T(T(g go^T) + go_b))               per (frame, channel)
    out = T(T(y2 * gates) + x)

On the card the unit is five launches (``unit_launches``, ``csrc/
residual_unit.cu``) on scratch the wrappers allocate, each with its own
wrapper and plain version:

1. ``ru_conv``: the causal conv as an implicit GEMM with the bias + ELU
   epilogue: M = output pixels, N = C, K = 27 C in tap-major order against
   the weight re-laid as ``(C_out, 27 C_in)`` (``relaid_conv_weight``,
   cached per parameter). No im2col exists in device memory.
2. ``ru_pointwise``: the 1x1 on the same GEMM with a dense A.
3. ``se_logits``: a group of lanes a pixel, 16-byte loads.
4. ``se_gates``: the SqueezeExcite reduction: each frame's softmax max and
   sum, partial contexts over (frame, pixel slice) blocks (``se_slices``
   slices a frame, so the card gets more than B*T blocks), then a block
   per frame sums its slices in a fixed order and runs the gate MLP. No
   atomics, and the slices depend on the frame's size alone: a frame's
   gates do not depend on the schedule or on the batch it is in.
5. ``gate_residual``: ``out = T(T(y2 * gates) + x)`` in place on y2.

The GEMMs take one of three routes, picked by :func:`ru_conv_route` and
counted apart (``ru_conv_*`` and ``ru_pointwise_*``):

- ``'wgmma'``: bf16 with C % 64 == 0, every flagship stage. TMA fills a ring
  of 128-byte-swizzled shared memory and two warpgroups run ``wgmma`` on
  128 x 128 output tiles (128 x 64 at C = 64), ``csrc/gemm.cu``'s
  pipeline. A conv M tile is a 16 x 8 pixel box of one frame; the A tile of
  each tap is one box of a 5-D tensor map over x, whose out-of-bounds zero
  fill supplies the causal and spatial pads (so no tap reaches into batch
  element b - 1), and a tile in frame 0 or 1 skips the taps before frame 0.
  At C = 64 one box of 16 x 10 pixels (the tile and its row halo) serves
  the three taps that differ only in dh.
- ``'wmma'``: bf16 with C % 64 == 32: warp-level WMMA on 128 x 64 tiles with
  a predicated ``cp.async`` gather of the taps.
- ``'f32'``: float32 on the CUDA cores (no TF32).

A route that does not fit the call raises; nothing falls back.

What bounds it on the H100: the conv. At C = 512, T = 20, 16 x 16 (batch 8)
the unit is 528 GFLOP, counting only the conv taps that read a real pixel
(601 GFLOP if the causal and spatial pads were multiplied too), against
~84 MB of activation I/O: 0.53 ms at 989 dense bf16 TFLOP/s against
0.03 ms at 3.35 TB/s, so compute-bound at every stage. The other four
launches are bound by bytes: each reads or writes the activation once or
twice. Scratch costs one extra round trip of the activation (y1).

Kernel limits (the wrappers raise outside them, the gates below keep the
module path inside them): channels-last input, C == dim, C % 32 == 0,
C <= 1024 and SE hidden <= 1024 (the frame block's shared arrays), kernel
size (3, 3, 3) with zero padding, float32 or bfloat16.

On the CPU the wrappers run the plain version below, and autograd
differentiates it. On a CUDA tensor they launch the kernel or raise; the
backward recomputes through ``residual_unit_ref`` (``_Unit``), as the JAX
custom VJPs recompute through their XLA twins.
"""

from __future__ import annotations

import os
import weakref

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.conv import (
    pad_time_front, to_channels_first, to_channels_last)
from magvit2_pytorch_tpu_torch.ops.kernels import _build
from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple

RU_ROUTES = {'f32': 0, 'wmma': 1, 'wgmma': 2}   # csrc/residual_unit.cu RuRoute
# launches since the last reset (see ops/kernels): the units by entry, and
# inside them the conv and the 1x1 by route
LAUNCHES = {'residual_unit_wide': 0, 'residual_unit_packed': 0,
            'residual_unit_wide_backward': 0,
            'residual_unit_packed_backward': 0,
            **{f'ru_conv_{r}': 0 for r in RU_ROUTES},
            **{f'ru_pointwise_{r}': 0 for r in RU_ROUTES}}
WGMMA_MULTIPLE = 64    # K tile (one 128-byte swizzle row of bf16) and N step
MAX_CHANNELS = 1024    # csrc/residual_unit.cu kSeMaxC
# the SqueezeExcite reduction's pixel slices a frame: at most 8, none under
# 16 pixels
SE_SLICES = 8
SE_MIN_SLICE = 16


def residual_unit_ref(x, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b,
                      go_w, go_b):
    """Plain version on ``(B, T, H, W, C)`` in the port's parameter layouts:
    conv_w ``(C, C, 3, 3, 3)``, pw_w ``(C, C)``, k_w ``(1, C)``, k_b
    ``(1,)``, gi_w ``(hidden, C)``, go_w ``(C, hidden)`` — the port's copy
    of ``_residual_unit_xla_plain`` (``residual_unit_wide.py:159-190``),
    +x included."""
    dt = x.dtype
    cast = lambda t: t.to(dt)
    xc = to_channels_first(pad_time_front(x, 2))
    if not x.is_cuda:
        # PyTorch's CPU conv on the channels-last view loses ~2.5e-5 of
        # float32 at K = 27 * 128 (measured against float64); the
        # contiguous layout keeps it at ~6e-6
        xc = xc.contiguous()
    y = F.conv3d(xc, cast(conv_w), padding=(0, 1, 1))
    y = F.elu(to_channels_last(y) + cast(conv_b))
    y = F.elu(F.linear(y, cast(pw_w)) + cast(pw_b))
    b, t, h, w, c = y.shape
    logits = (F.linear(y, cast(k_w)) + cast(k_b)).float().reshape(b, t, h * w)
    attn = torch.softmax(logits, dim=-1).to(dt)
    context = torch.matmul(attn.float().unsqueeze(-2),
                           y.float().reshape(b, t, h * w, c)).to(dt)
    g = F.leaky_relu(F.linear(context, cast(gi_w)) + cast(gi_b), 0.1)
    gates = torch.sigmoid(F.linear(g, cast(go_w)) + cast(go_b))
    return gates.reshape(b, t, 1, 1, c) * y + x


# -- the five launches: routes, plain versions --------------------------------


def ru_conv_route(c: int, dtype) -> str:
    """The route of the unit's conv and 1x1 at C = ``c`` in ``dtype``:
    float32 takes ``'f32'``; bf16 takes ``'wgmma'`` when C is a multiple of
    64, else ``'wmma'``. H, W and T do not matter: TMA zero-fills a box
    past the frame and the epilogue does not store it. The wrappers hand
    the kernels 16-byte-aligned operands (TMA's base), and the kernels
    refuse others."""
    if dtype == torch.float32:
        return 'f32'
    return 'wgmma' if c % WGMMA_MULTIPLE == 0 else 'wmma'


def se_slices(hw: int) -> int:
    """Pixel slices a frame of ``hw`` pixels is cut into for the partial
    contexts: ``SE_SLICES``, none under ``SE_MIN_SLICE`` pixels and none
    empty. It depends on the frame alone, so a frame's context sums in the
    same order whatever the batch: at the flagship's 40-160 frames a stage
    that is 320-1280 blocks, at least two an SM of an H100."""
    want = max(1, min(SE_SLICES, hw // SE_MIN_SLICE))
    per = -(-hw // want)
    return -(-hw // per)


def _aligned16(t):
    return t.clone() if t.data_ptr() % 16 else t


# id(conv weight) -> (weak reference, key, re-laid weight)
_RELAID: dict = {}


def relaid_conv_weight(conv_w, dtype):
    """The conv weight ``(C_out, C_in, 3, 3, 3)`` as the GEMM's B operand
    ``(C_out, 27 C_in)``, tap-major ``(dt, dh, dw, c_in)``, in ``dtype``.
    Cached per parameter, keyed on its storage, version counter and the
    dtype, so an in-place update (an optimizer step, ``load_state_dict``)
    re-lays it; an inference tensor has no version counter and is re-laid
    on every call. Only the card path uses it.

    An update through ``param.data`` (``p.data.copy_(...)``, an EMA's
    ``p.data.mul_(...)``) writes through a tensor with a version counter of
    its own, so this cache does not see it: call
    :func:`forget_relaid_weights` after such an update."""
    c = conv_w.shape[0]
    key = None
    if not conv_w.is_inference():
        key = (conv_w.data_ptr(), conv_w._version, dtype, conv_w.device)
        entry = _RELAID.get(id(conv_w))
        if entry is not None and entry[0]() is conv_w and entry[1] == key:
            return entry[2]
    # a new allocation (the permute makes reshape copy): 16-byte aligned
    wr = conv_w.to(dtype).permute(0, 2, 3, 4, 1).reshape(c, 27 * c)
    if key is not None:
        i = id(conv_w)
        _RELAID[i] = (weakref.ref(conv_w, lambda _, i=i: _RELAID.pop(i, None)),
                      key, wr)
    return wr


def forget_relaid_weights():
    """Drop every cached re-lay of :func:`relaid_conv_weight`; the next
    call of each unit re-lays its weight."""
    _RELAID.clear()


def conv_ref(x, conv_w, conv_b):
    """Plain version of :func:`ru_conv`: ``y1 = ELU(T(T(conv(x)) +
    conv_b))`` on ``(B, T, H, W, C)``, causal in time, zero pads."""
    dt = x.dtype
    xc = to_channels_first(pad_time_front(x, 2))
    if not x.is_cuda:
        xc = xc.contiguous()    # see residual_unit_ref
    y = F.conv3d(xc, conv_w.to(dt), padding=(0, 1, 1))
    return F.elu(to_channels_last(y) + conv_b.to(dt))


def pointwise_ref(y1, pw_w, pw_b):
    """Plain version of :func:`ru_pointwise`: ``ELU(T(T(y1 pw^T) + pw_b))``."""
    dt = y1.dtype
    return F.elu(F.linear(y1, pw_w.to(dt)) + pw_b.to(dt))


def se_logits_ref(y2, k_w, k_b):
    """Plain version of :func:`se_logits`: ``float(T(T(y2 . k) + kb))`` per
    pixel, ``(B * T * H * W,)``."""
    dt = y2.dtype
    return (F.linear(y2, k_w.to(dt)) + k_b.to(dt)).float().reshape(-1)


def se_gates_ref(y2, logits, gi_w, gi_b, go_w, go_b):
    """Plain version of :func:`se_gates`: the frame's softmax (float32,
    then T), ``context = T(sum attn y2)`` in float32, the gate MLP;
    ``(B * T, C)``."""
    dt = y2.dtype
    b, t, h, w, c = y2.shape
    attn = torch.softmax(logits.reshape(b * t, h * w), dim=-1).to(dt)
    context = torch.matmul(attn.float().unsqueeze(-2),
                           y2.float().reshape(b * t, h * w, c)).to(dt)
    g = F.leaky_relu(F.linear(context, gi_w.to(dt)) + gi_b.to(dt), 0.1)
    return torch.sigmoid(F.linear(g, go_w.to(dt)) + go_b.to(dt)).reshape(
        b * t, c)


def gate_residual_ref(y2, gates, x):
    """Plain version of :func:`gate_residual`: ``T(T(y2 * gates) + x)``."""
    b, t, _, _, c = y2.shape
    return gates.reshape(b, t, 1, 1, c) * y2 + x


# -- the five launches on the card --------------------------------------------


def _ru_gemm(a, w, bias, conv: bool, route: str | None):
    what = 'ru_conv' if conv else 'ru_pointwise'
    b, t, h, wd, c = a.shape
    a = _aligned16(a.contiguous())
    route = route or ru_conv_route(c, a.dtype)
    out = torch.empty_like(a)
    lib = _build.load_library()
    code = lib.mv2_ru_gemm(
        a.data_ptr(), w.data_ptr(), bias.to(a.dtype).contiguous().data_ptr(),
        out.data_ptr(), _build.dtype_code(a), b, t, h, wd, c, int(conv),
        RU_ROUTES[route], _build.stream_handle(a.device))
    _build.check(lib, code, f'{what} {tuple(a.shape)} route {route}')
    LAUNCHES[f'{what}_{route}'] += 1
    return out


def ru_conv(x, conv_w, conv_b, route: str | None = None):
    """Launch 1, the causal 3x3x3 conv + bias + ELU on ``(B, T, H, W, C)``
    (see ``conv_ref``); ``route`` overrides :func:`ru_conv_route` (to time
    one route against another), and the kernel raises if the call does not
    fit it."""
    if not x.is_cuda:
        return conv_ref(x, conv_w, conv_b)
    _build.check_cuda_inputs('ru_conv', x, (conv_w, conv_b))
    return _ru_gemm(x, relaid_conv_weight(conv_w, x.dtype), conv_b, True,
                    route)


def ru_pointwise(y1, pw_w, pw_b, route: str | None = None):
    """Launch 2, the 1x1 + bias + ELU on ``(B, T, H, W, C)`` (see
    ``pointwise_ref``), on the GEMM of :func:`ru_conv`."""
    if not y1.is_cuda:
        return pointwise_ref(y1, pw_w, pw_b)
    _build.check_cuda_inputs('ru_pointwise', y1, (pw_w, pw_b))
    w = _aligned16(pw_w.to(y1.dtype).contiguous())
    return _ru_gemm(y1, w, pw_b, False, route)


def se_logits(y2, k_w, k_b):
    """Launch 3, the SqueezeExcite logits (see ``se_logits_ref``)."""
    if not y2.is_cuda:
        return se_logits_ref(y2, k_w, k_b)
    _build.check_cuda_inputs('se_logits', y2, (k_w, k_b))
    c = y2.shape[-1]
    y2 = _aligned16(y2.contiguous())      # 16-byte loads of y2 and k
    k = _aligned16(k_w.to(y2.dtype).contiguous())
    logits = torch.empty(y2.numel() // c, dtype=torch.float32,
                         device=y2.device)
    lib = _build.load_library()
    _build.check(lib, lib.mv2_ru_se_logits(
        y2.data_ptr(), k.data_ptr(),
        k_b.to(y2.dtype).contiguous().data_ptr(), logits.data_ptr(),
        _build.dtype_code(y2), logits.numel(), c,
        _build.stream_handle(y2.device)), 'se_logits')
    return logits


def se_gates(y2, logits, gi_w, gi_b, go_w, go_b):
    """Launch 4, the SqueezeExcite reduction and gate MLP (see
    ``se_gates_ref``): partial contexts over ``se_slices`` slices a frame."""
    if not y2.is_cuda:
        return se_gates_ref(y2, logits, gi_w, gi_b, go_w, go_b)
    _build.check_cuda_inputs('se_gates', y2, (logits, gi_w, gi_b, go_w, go_b))
    b, t, h, w, c = y2.shape
    frames, hw, hidden = b * t, h * w, gi_w.shape[0]
    slices = se_slices(hw)
    y2 = _aligned16(y2.contiguous())
    stats = torch.empty((frames, 2), dtype=torch.float32, device=y2.device)
    partial = torch.empty((frames, slices, c), dtype=torch.float32,
                          device=y2.device)
    gates = torch.empty((frames, c), dtype=y2.dtype, device=y2.device)
    weights = [p.to(y2.dtype).contiguous() for p in (gi_w, gi_b, go_w, go_b)]
    lib = _build.load_library()
    _build.check(lib, lib.mv2_ru_se_gates(
        y2.data_ptr(), logits.contiguous().data_ptr(),
        *(p.data_ptr() for p in weights), stats.data_ptr(),
        partial.data_ptr(), gates.data_ptr(), _build.dtype_code(y2), frames,
        hw, c, hidden, slices, _build.stream_handle(y2.device)), 'se_gates')
    return gates


def gate_residual(y2, gates, x):
    """Launch 5, ``T(T(y2 * gates) + x)`` (see ``gate_residual_ref``); on
    the card in place on ``y2``, which it returns."""
    if not y2.is_cuda:
        return gate_residual_ref(y2, gates, x)
    _build.check_cuda_inputs('gate_residual', y2, (gates, x))
    if not y2.is_contiguous() or y2.data_ptr() % 16:
        raise ValueError('gate_residual: y2 is updated in place with 16-byte '
                         'stores: it must be contiguous and 16-byte aligned')
    x, gates = (_aligned16(t.contiguous()) for t in (x, gates))
    b, t, h, w, c = y2.shape
    lib = _build.load_library()
    _build.check(lib, lib.mv2_ru_gate_residual(
        y2.data_ptr(), x.data_ptr(), gates.data_ptr(), _build.dtype_code(y2),
        y2.numel() // c, h * w, c, _build.stream_handle(y2.device)),
        'gate_residual')
    return y2


def unit_launches(x, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w,
                  go_b):
    """The unit as its five launches on ``x (B, T, H, W, C)``. On CPU
    tensors each takes its plain version, so the composition is testable
    there."""
    y1 = ru_conv(x, conv_w, conv_b)
    y2 = ru_pointwise(y1, pw_w, pw_b)
    del y1
    logits = se_logits(y2, k_w, k_b)
    gates = se_gates(y2, logits, gi_w, gi_b, go_w, go_b)
    return gate_residual(y2, gates, x)


# -- gates (the JAX package's, with the CUDA kernel's limits) -----------------


def _env_flag(name: str) -> bool:
    return os.environ.get(name, '') == '1'


def _kernel_takes(x, dim: int, kernel_size, pad_mode: str,
                  streaming: bool) -> bool:
    if _env_flag('MAGVIT2_TPU_NO_FUSED_RU') or streaming:
        return False
    if cast_tuple(kernel_size, 3) != (3, 3, 3):
        return False
    if pad_mode not in ('constant', 'zeros') or x.ndim != 5:
        return False
    if x.dtype not in _build.DTYPE_CODES:
        return False
    c = x.shape[-1]
    return c == dim and c % 32 == 0 and c <= MAX_CHANNELS


def wide_eligible(x, dim: int, kernel_size, pad_mode: str = 'constant',
                  streaming: bool = False) -> bool:
    """B4 on the module path: opt-in per channel count through
    ``MAGVIT2_TPU_FUSED_RU_WIDE_DIMS`` (comma-separated, empty by default),
    with the kill switches ``MAGVIT2_TPU_NO_FUSED_RU``,
    ``MAGVIT2_TPU_NO_FUSED_RU_WIDE`` and, at C = 64,
    ``MAGVIT2_TPU_NO_FUSED_RU_W64`` — read at call time, with the JAX
    package's meanings (``residual_unit_wide.py:196-245``)."""
    if not _kernel_takes(x, dim, kernel_size, pad_mode, streaming):
        return False
    if _env_flag('MAGVIT2_TPU_NO_FUSED_RU_WIDE'):
        return False
    dims = {int(d) for d in os.environ.get(
        'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS', '').split(',') if d}
    c = x.shape[-1]
    if c not in dims:
        return False
    return not (c == 64 and _env_flag('MAGVIT2_TPU_NO_FUSED_RU_W64'))


def fused_eligible(x, dim: int, kernel_size, w_blocked: bool,
                   pad_mode: str = 'constant',
                   streaming: bool = False) -> bool:
    """B5 on the module path: only for the ResidualUnits of the lane-packed
    stem (``w_blocked``, set by ``lane_pack``) at C = 64, the JAX gate's one
    width (2 C = 128), unless ``MAGVIT2_TPU_NO_FUSED_RU=1``
    (``residual_unit.py:280-328``)."""
    return (w_blocked and x.shape[-1] == 64
            and _kernel_takes(x, dim, kernel_size, pad_mode, streaming))


# -- the CUDA launch ----------------------------------------------------------


def _launch(x, params, name: str):
    _build.check_cuda_inputs(name, x, params)
    if x.ndim != 5:
        raise ValueError(f'{name}: x must be (B, T, H, W, C), got '
                         f'{tuple(x.shape)}')
    c = x.shape[-1]
    hidden = params[6].shape[0]
    if c % 32 or c > MAX_CHANNELS or hidden > MAX_CHANNELS:
        raise ValueError(f'{name}: the kernel takes C % 32 == 0, C <= '
                         f'{MAX_CHANNELS} and hidden <= {MAX_CHANNELS}; got '
                         f'C={c}, hidden={hidden}')
    shapes = ((c, c, 3, 3, 3), (c,), (c, c), (c,), (1, c), (1,), (hidden, c),
              (hidden,), (c, hidden), (c,))
    for p, want in zip(params, shapes):
        if tuple(p.shape) != want:
            raise ValueError(f'{name}: parameter {tuple(p.shape)} does not '
                             f'fit {want} for C={c}, hidden={hidden}')
    out = unit_launches(_aligned16(x.contiguous()), *params)
    LAUNCHES[name] += 1
    return out


class _Unit(torch.autograd.Function):
    """The unit on the card: the forward launches the kernels; the backward
    recomputes through ``residual_unit_ref`` (the port's copy of
    ``_residual_unit_xla_plain``) and differentiates it, as the JAX custom
    VJPs do (``residual_unit_wide.py:320-334``; ``residual_unit.py:417-441``
    differentiates the blocked twin, the same function on the packed view of
    the same bytes, which the caller's reshape carries here)."""

    @staticmethod
    def forward(ctx, name, x, *params):
        ctx.save_for_backward(x, *params)
        ctx.name = name
        return _launch(x, params, name)

    @staticmethod
    def backward(ctx, grad):
        LAUNCHES[f'{ctx.name}_backward'] += 1
        return (None, *_build.recompute_grads(
            residual_unit_ref, ctx.saved_tensors, ctx.needs_input_grad[1:],
            grad))


def fused_residual_unit_wide(x, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w,
                             gi_b, go_w, go_b):
    """B4: the unit on ``(B, T, H, W, C)``, +x included (see
    ``residual_unit_ref`` for the parameter layouts); differentiable on
    both devices."""
    params = (conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w, go_b)
    if not x.is_cuda:
        return residual_unit_ref(x, *params)
    return _Unit.apply('residual_unit_wide', x, *params)


def fused_residual_unit(xb, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b,
                        go_w, go_b, packed_io: bool = True):
    """B5: the unit on the lane-packed ``(B, T, H, W/2, 2C)`` view
    (``packed_io=True``) or on the unpacked ``(B, T, H, W, C)`` activation
    (``packed_io=False``), +x included; the result has the input's layout.
    Parameters in the unpacked layouts of ``residual_unit_ref``;
    differentiable on both devices."""
    params = (conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w, go_b)
    c = conv_w.shape[0]
    if packed_io:
        b, t, h, w2, c2 = xb.shape
        if c2 != 2 * c:
            raise ValueError(f'packed input {tuple(xb.shape)} does not fit '
                             f'C={c}')
        x = xb.reshape(b, t, h, 2 * w2, c)
    else:
        x = xb
    if not x.is_cuda:
        out = residual_unit_ref(x, *params)
    else:
        out = _Unit.apply('residual_unit_packed', x, *params)
    return out.reshape(xb.shape)
