"""int8 inference convs (``csrc/int8_conv.cu``): K1 quantizes an activation,
K2 runs the conv s8 x s8 -> s32 on the tensor cores and dequantizes.

The JAX package's int8 path (``MAGVIT2_TPU_INT8_CONV=1``) has no Pallas
kernel: XLA lowers its ``conv_general_dilated(..., preferred_element_type=
int32)`` on the TPU's int8 MXU. PyTorch has no int8 ``conv3d`` on CUDA, so on
the card these two hand-written kernels take its place (queue A item 14).
The numbers are the JAX package's (``magvit2_pytorch_tpu/ops/conv.py:77-104,
521-571, 620-650``, ``ops/resample.py:73-101, 216-227``), with T the
working dtype:

    s  = max(absmax(x), 1e-12) / 127           float32; static: given
    xq = clip(round_half_even(x / s), -127, 127)     IEEE division
    acc = conv(xq, kq)                         exact int32
    out = T(float(acc) * (s * ks[n])) + T(bias[n])   the product s * ks
                                               first, one rounding each

- K1 ``quantize_s8``: the dynamic path's absmax (a grid reduction) and the
  quantize, or the quantize alone with a static scale. Bound: bytes.
- K2 ``conv_s8``: an implicit GEMM on ``mma.sync.m16n8k32`` s8 with int32
  accumulators in registers, M = output pixels, N = output columns, K =
  taps x C tap-major against the weight re-laid as ``(N, K)`` int8. The
  causal 3x3x3 conv's frames in front and the spatial pads are zero taps
  of its index math; strides (1, s, s) serve the 1x3x3 stride-2
  downsampler; a 1x1 kernel serves the units' 1x1 and the spatial
  upsampler's ``C -> 4 dim_out`` GEMM, whose output K2 writes
  depth-to-space (``depth_to_space=True``: columns in ``(p1, p2, c)``
  order, so a column pair is two neighbouring channels of one pixel).
  Bound: operations at the unit convs, bytes at the others. Its debug
  entry ``conv_s8_accumulators`` returns the raw int32 sums, which the
  card holds exactly against ``conv_s8_ref``.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises (no fallback), and each
launch adds one to ``LAUNCHES`` (K1 counts one a call, its absmax included).
The plain versions: ``quantize_ref`` and ``conv_s8_ref``, which runs
``F.conv3d`` in float64 on the integer values: exact, since |acc| <= 127^2
x 27 x 512 ~ 2.2e8 is far below 2^53.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.kernels import _build

# launches since the last reset (see ops/kernels); K2's also by input
# channels
LAUNCHES = {'quantize_s8': 0, 'conv_s8': 0}
CONV_S8_BY_C_IN = {}
MODES = {'out': 0, 'depth_to_space': 1, 'raw': 2}   # csrc/int8_conv.cu S8Mode
QMAX = 127
SCALE_FLOOR = 1e-12
CHANNEL_MULTIPLE = 16   # K2 loads 16-byte chunks of one tap


class Int8Weight(NamedTuple):
    """A quantized conv weight: ``q (N, C, kt, kh, kw)`` int8, ``scale
    (N,)`` float32 per output column, and on the card ``gemm``, q re-laid
    as K2's ``(N, kt * kh * kw * C)`` tap-major operand."""
    q: torch.Tensor
    scale: torch.Tensor
    gemm: Optional[torch.Tensor]


def int8_weight(q, scale) -> Int8Weight:
    """``Int8Weight`` from a 5-D int8 weight and its column scales; the
    re-lay is made once, here, on the card."""
    gemm = None
    if q.is_cuda:
        gemm = q.permute(0, 2, 3, 4, 1).reshape(q.shape[0], -1).contiguous()
    return Int8Weight(q, scale.float().contiguous(), gemm)


def scale_of(amax):
    """``max(amax, 1e-12) / 127`` in float32. The divisor is a tensor: a
    CUDA tensor divided by a Python scalar is multiplied by its reciprocal,
    which is not IEEE division."""
    amax = amax.float()
    return (torch.maximum(amax, amax.new_tensor(SCALE_FLOOR))
            / amax.new_tensor(float(QMAX)))


def quantize_with(x32, scale):
    """``clip(round(x / scale), -127, 127)`` as int8, x in float32; round
    half to even (``torch.round``, as ``jnp.round``)."""
    return torch.round(x32 / scale).clamp_(-QMAX, QMAX).to(torch.int8)


# -- K1 -----------------------------------------------------------------------


def quantize_ref(x, scale=None):
    """Plain version of :func:`quantize_s8`: ``(xq int8, scale)``, the scale
    a float32 0-d tensor, computed from x's absmax when not given."""
    x32 = x.float()
    if scale is None:
        scale = scale_of(x32.abs().amax() if x32.numel()
                         else x32.new_zeros(()))
    return quantize_with(x32, scale.to(x32.device, torch.float32)), scale


def quantize_s8(x, scale=None):
    """K1: x (float32 or bf16) -> ``(xq int8 of x's shape, scale float32
    0-d)``; ``scale`` given (the static path), only the quantize runs."""
    if not x.is_cuda:
        return quantize_ref(x, scale)
    _build.check_cuda_inputs('quantize_s8', x, () if scale is None
                             else (scale,))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    amax = scale_out = None
    if scale is None:
        amax = torch.empty((), dtype=torch.int32, device=x.device)
        scale_out = torch.empty((), dtype=torch.float32, device=x.device)
    else:
        scale = scale.to(torch.float32).contiguous()
    lib = _build.load_library()
    _build.check(lib, lib.mv2_quantize_s8(
        x.data_ptr(), _build.dtype_code(x), x.numel(),
        None if scale is None else scale.data_ptr(),
        None if amax is None else amax.data_ptr(),
        None if scale_out is None else scale_out.data_ptr(), q.data_ptr(),
        _build.stream_handle(x.device)), f'quantize_s8 {tuple(x.shape)}')
    LAUNCHES['quantize_s8'] += 1
    return q, (scale_out if scale is None else scale)


# -- K2 -----------------------------------------------------------------------


def conv_s8_ref(xq, wq, stride: int = 1):
    """Plain version of K2's accumulators: xq ``(B, T, H, W, C)`` int8, wq
    ``(N, C, kt, kh, kw)`` int8 -> int32 ``(B, T, Ho, Wo, N)``: the conv with
    ``kt - 1`` zero frames in front, zero pads ``kh // 2``, ``kw // 2`` and
    strides ``(1, stride, stride)``, in float64 (exact)."""
    kt, kh, kw = wq.shape[2:]
    x = xq.permute(0, 4, 1, 2, 3).to(torch.float64)
    x = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
    acc = F.conv3d(x, wq.to(torch.float64), stride=(1, stride, stride),
                   padding=(0, kh // 2, kw // 2))
    return acc.permute(0, 2, 3, 4, 1).contiguous().to(torch.int32)


def dequantize_ref(acc, xs, ks, bias, dtype, depth_to_space: bool = False):
    """Plain version of K2's epilogue on ``acc (..., N)``: ``T(float(acc) *
    (xs * ks))`` then ``+ T(bias)``; ``depth_to_space`` moves column ``(p1,
    p2, c)`` of pixel ``(h, w)`` to channel c of pixel ``(2 h + p1, 2 w +
    p2)``."""
    out = (acc.float() * (xs * ks)).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)
    if depth_to_space:
        b, t, h, w, n = out.shape
        out = out.reshape(b, t, h, w, 2, 2, n // 4).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(b, t, 2 * h, 2 * w, n // 4)
    return out


def _launch_conv(xq, weight: Int8Weight, stride: int, mode: str, xs=None,
                 bias=None, dtype=None):
    what = f'conv_s8 {tuple(xq.shape)} x {tuple(weight.q.shape)}'
    if xq.dtype != torch.int8 or weight.q.dtype != torch.int8:
        raise TypeError(f'{what}: int8 operands only')
    if xq.ndim != 5:
        raise ValueError(f'{what}: x must be (B, T, H, W, C)')
    b, t, h, w, c = xq.shape
    n, c_w, kt, kh, kw = weight.q.shape
    if c_w != c or c % CHANNEL_MULTIPLE:
        raise ValueError(f'{what}: K2 takes C_in % {CHANNEL_MULTIPLE} == 0 '
                         'matching the weight')
    if weight.gemm is None or not weight.gemm.is_cuda:
        raise ValueError(f'{what}: the weight has no re-lay on the card')
    tensors = [t_ for t_ in (weight.gemm, weight.scale, xs, bias)
               if t_ is not None]
    if any(not t_.is_cuda or t_.device != xq.device for t_ in tensors):
        raise ValueError(f'{what}: every tensor must be on {xq.device}')
    xq = xq.contiguous()
    if xq.data_ptr() % 16:
        xq = xq.clone()
    ho = (h + 2 * (kh // 2) - kh) // stride + 1
    wo = (w + 2 * (kw // 2) - kw) // stride + 1
    if mode == 'raw':
        out = torch.empty((b, t, ho, wo, n), dtype=torch.int32,
                          device=xq.device)
        code = _build.DTYPE_CODES[torch.float32]
    else:
        if dtype not in _build.DTYPE_CODES:
            raise TypeError(f'{what}: output float32 or bfloat16')
        shape = ((b, t, 2 * ho, 2 * wo, n // 4) if mode == 'depth_to_space'
                 else (b, t, ho, wo, n))
        out = torch.empty(shape, dtype=dtype, device=xq.device)
        code = _build.DTYPE_CODES[dtype]
        if bias is not None:
            bias = bias.to(dtype).contiguous()
        xs = xs.to(torch.float32).contiguous()
    lib = _build.load_library()
    _build.check(lib, lib.mv2_conv_s8(
        xq.data_ptr(), weight.gemm.data_ptr(),
        None if xs is None else xs.data_ptr(), weight.scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), code, b,
        t, h, w, c, n, kt, kh, kw, stride, MODES[mode],
        _build.stream_handle(xq.device)), what)
    LAUNCHES['conv_s8'] += 1
    CONV_S8_BY_C_IN[c] = CONV_S8_BY_C_IN.get(c, 0) + 1
    return out


def conv_s8(xq, xs, weight: Int8Weight, bias, dtype, stride: int = 1,
            depth_to_space: bool = False):
    """K2: the int8 conv of ``xq`` (scale ``xs``) with ``weight``,
    dequantized to ``dtype`` with ``bias`` added (see ``dequantize_ref``)."""
    if not xq.is_cuda:
        acc = conv_s8_ref(xq, weight.q, stride)
        return dequantize_ref(acc, xs, weight.scale, bias, dtype,
                              depth_to_space)
    return _launch_conv(xq, weight, stride,
                        'depth_to_space' if depth_to_space else 'out', xs,
                        bias, dtype)


def conv_s8_accumulators(xq, weight: Int8Weight, stride: int = 1):
    """K2's debug entry: the raw int32 accumulators ``(B, T, Ho, Wo, N)``
    (``conv_s8_ref`` on the CPU)."""
    if not xq.is_cuda:
        return conv_s8_ref(xq, weight.q, stride)
    return _launch_conv(xq, weight, stride, 'raw')


def int8_conv(x, weight: Int8Weight, bias, stride: int = 1, act_scale=None,
              depth_to_space: bool = False):
    """An int8 site: K1 on x (``act_scale`` given: the static scale), then
    K2; the output in x's dtype."""
    xq, xs = quantize_s8(x, act_scale)
    return conv_s8(xq, xs, weight, bias, x.dtype, stride, depth_to_space)


# -- quantized weights, once per weight version ------------------------------


# id(weight) -> (weak reference, key, Int8Weight)
_QUANTIZED: dict = {}


def cached_int8_weight(param, dtype, make):
    """``make(param.to(dtype))`` (an ``Int8Weight``), cached per parameter
    and keyed on its storage, version counter and ``dtype`` as
    ``residual_unit.relaid_conv_weight`` keys its re-lay: an in-place update
    quantizes anew (an update through ``param.data`` does not bump the
    version: call :func:`forget_int8_weights` after one), and an inference
    tensor (a parameter made under ``torch.inference_mode``) has no version
    counter and is quantized on every call. The numbers are those of
    quantizing on every call."""
    key = None
    if not param.is_inference():
        key = (param.data_ptr(), param._version, dtype, param.device)
        entry = _QUANTIZED.get(id(param))
        if entry is not None and entry[0]() is param and entry[1] == key:
            return entry[2]
    out = make(param.to(dtype))
    if key is not None:
        i = id(param)
        _QUANTIZED[i] = (weakref.ref(param,
                                     lambda _, i=i: _QUANTIZED.pop(i, None)),
                         key, out)
    return out


def forget_int8_weights():
    """Drop every cached quantized weight of :func:`cached_int8_weight`."""
    _QUANTIZED.clear()


def conv_macs(x_shape, weight_shape, stride: int = 1):
    """Multiply-adds of K2 on ``x (B, T, H, W, C)`` over the taps that read
    a pixel of the clip (the causal and spatial pads multiply zeros): the
    work a bound counts."""
    b, t, h, w, c = x_shape
    n, _, kt, kh, kw = weight_shape
    ho = (h + 2 * (kh // 2) - kh) // stride + 1
    wo = (w + 2 * (kw // 2) - kw) // stride + 1

    def visible(n_out, n_in, k, pad, s):
        return sum(1 for o in range(n_out) for d in range(k)
                   if 0 <= o * s + d - pad < n_in)

    frames = sum(1 for o in range(t) for d in range(kt)
                 if 0 <= o + d - (kt - 1) < t)
    return (b * frames * visible(ho, h, kh, kh // 2, stride)
            * visible(wo, w, kw, kw // 2, stride) * n * c)

