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

The CUDA version (``csrc/residual_unit.cu``) runs it as five launches on
scratch the wrapper allocates: an implicit-GEMM causal conv with the
bias + ELU epilogue (M = output pixels, N = C, K = 27 C in tap-major order;
the A tile is gathered from channels-last x with zero predicates for the
causal and spatial pads, so no im2col exists in device memory), the 1x1
GEMM with its epilogue, one warp per pixel for the SE logits, one block per
frame for softmax, context and the gate MLP, and an elementwise gate +
residual pass. Each block computes its conv taps from indices; a tap before
frame 0 of its own batch element reads zero, so no tap reaches into
batch element b - 1 (the TPU kernel's 3-slot frame ring across a
sequential grid has no counterpart here).

What bounds it on the H100: the conv. At C = 512, T = 20, 16 x 16 (batch 8)
the unit is 528 GFLOP, counting only the conv taps that read a real pixel
(601 GFLOP if the causal and spatial pads were multiplied too), against
~84 MB of activation I/O: 0.53 ms at 989 dense bf16 TFLOP/s against
0.03 ms at 3.35 TB/s, so compute-bound at every stage.
bf16 runs on the tensor cores (WMMA ``mma.sync``, 128x64 tiles, 3-stage
``cp.async`` pipeline), float32 on the CUDA cores (no TF32). Scratch costs
one extra round trip of the activation (y1) plus the SE passes; ``wgmma``,
TMA and keeping y1 on chip are later work.

Kernel limits (the wrappers raise outside them, the gates below keep the
module path inside them): channels-last input, C == dim, C % 32 == 0 (one
32-wide K chunk of the conv never straddles two taps; 16-byte loads),
C <= 1024 and SE hidden <= 1024 (the frame block's shared arrays), kernel
size (3, 3, 3) with zero padding, float32 or bfloat16, forward only.

On the CPU the wrappers run the plain version below. On a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.conv import (
    pad_time_front, to_channels_first, to_channels_last)
from magvit2_pytorch_tpu_torch.ops.kernels import _build
from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple

# launches of each CUDA kernel since the last reset (see ops/kernels)
LAUNCHES = {'residual_unit_wide': 0, 'residual_unit_packed': 0}

MAX_CHANNELS = 1024    # csrc/residual_unit.cu kSeMaxC


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


def _aligned16(t):
    return t.clone() if t.data_ptr() % 16 else t


def _launch(x, params, name: str):
    _build.check_cuda_inputs(name, x, params)
    conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w, go_b = params
    if x.ndim != 5:
        raise ValueError(f'{name}: x must be (B, T, H, W, C), got '
                         f'{tuple(x.shape)}')
    b, t, h, w, c = x.shape
    hidden = gi_w.shape[0]
    if c % 32 or c > MAX_CHANNELS or hidden > MAX_CHANNELS:
        raise ValueError(f'{name}: the kernel takes C % 32 == 0, C <= '
                         f'{MAX_CHANNELS} and hidden <= {MAX_CHANNELS}; got '
                         f'C={c}, hidden={hidden}')
    shapes = ((conv_w, (c, c, 3, 3, 3)), (conv_b, (c,)), (pw_w, (c, c)),
              (pw_b, (c,)), (k_w, (1, c)), (k_b, (1,)), (gi_w, (hidden, c)),
              (gi_b, (hidden,)), (go_w, (c, hidden)), (go_b, (c,)))
    for p, want in shapes:
        if tuple(p.shape) != want:
            raise ValueError(f'{name}: parameter {tuple(p.shape)} does not '
                             f'fit {want} for C={c}, hidden={hidden}')
    dt = x.dtype
    # the GEMMs read x and pw_w with 16-byte loads
    x = _aligned16(x.contiguous())
    # the conv's B operand (C_out, 27 * C_in), tap-major (dt, dh, dw, c_in),
    # re-laid on every call: 27 C^2 values, 14 MB in bf16 at C = 512.
    # Caching it with the module is later work.
    wr = conv_w.to(dt).permute(0, 2, 3, 4, 1).reshape(c, 27 * c).contiguous()
    vec = [p.to(dt).contiguous() for p in
           (conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w, go_b)]
    vec[1] = _aligned16(vec[1])
    out = torch.empty_like(x)
    y1 = torch.empty_like(x)
    logits = torch.empty(b * t * h * w, dtype=torch.float32, device=x.device)
    gates = torch.empty((b * t, c), dtype=dt, device=x.device)
    lib = _build.load_library()
    code = lib.mv2_residual_unit(
        x.data_ptr(), wr.data_ptr(), *(p.data_ptr() for p in vec),
        out.data_ptr(), y1.data_ptr(), logits.data_ptr(), gates.data_ptr(),
        _build.dtype_code(x), b, t, h, w, c, hidden,
        _build.stream_handle(x.device))
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out


def fused_residual_unit_wide(x, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w,
                             gi_b, go_w, go_b):
    """B4: the unit on ``(B, T, H, W, C)``, +x included (see
    ``residual_unit_ref`` for the parameter layouts)."""
    params = (conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b, go_w, go_b)
    if not x.is_cuda:
        return residual_unit_ref(x, *params)
    return _launch(x, params, 'residual_unit_wide')


def fused_residual_unit(xb, conv_w, conv_b, pw_w, pw_b, k_w, k_b, gi_w, gi_b,
                        go_w, go_b, packed_io: bool = True):
    """B5: the unit on the lane-packed ``(B, T, H, W/2, 2C)`` view
    (``packed_io=True``) or on the unpacked ``(B, T, H, W, C)`` activation
    (``packed_io=False``), +x included; the result has the input's layout.
    Parameters in the unpacked layouts of ``residual_unit_ref``."""
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
        out = _launch(x, params, 'residual_unit_packed')
    return out.reshape(xb.shape)
