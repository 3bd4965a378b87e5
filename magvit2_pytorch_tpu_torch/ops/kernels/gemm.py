"""The launches the attention blocks share: the row RMSNorm and the
projection GEMM ``C = A W^T`` (``csrc/gemm.cu``).

The GEMM has three routes, picked here by a static shape rule
(:func:`gemm_route`) and passed to C, so the rule is testable on the CPU and
each route counts its own launches:

- ``'wgmma'``: bf16 with K and N multiples of 64 and 16-byte-aligned
  operands: TMA fills a 3-stage ring of 128-byte-swizzled shared memory and
  two warpgroups run ``wgmma`` on 128x128 output tiles. Every projection of
  the flagship's attention blocks qualifies.
- ``'wmma'``: any other bf16 shape: the 64x64 WMMA kernel.
- ``'f32'``: float32, on the CUDA cores (no TF32).

Neither route falls back to another: a call the route does not take raises.
Every route's epilogue takes one option, ``scaled_cols``: the first
``scaled_cols`` columns times ``col_scale`` in float32 before the one cast
(the Taylor block's ``q * d^-1/2``, cast once with k and v to bf16).
On the CPU the wrappers run the plain versions below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.kernels import _build

# launches of each GEMM route and of the row RMSNorm since the last reset
# (see ops/kernels)
LAUNCHES = {'gemm_wgmma': 0, 'gemm_wmma': 0, 'gemm_f32': 0, 'rmsnorm': 0}

ROUTES = {'f32': 0, 'wmma': 1, 'wgmma': 2}    # csrc/gemm.cu GemmRoute
WGMMA_MULTIPLE = 64     # K tile (one 128-byte swizzle row of bf16) and N step


def gemm_route(n: int, k: int, dtype, *tensors) -> str:
    """The route of ``C (m, n) = A (m, k) W (n, k)^T`` in ``dtype``: float32
    takes ``'f32'``; bf16 takes ``'wgmma'`` when k and n are multiples of 64
    and every operand starts 16-byte aligned (rows are then too), else
    ``'wmma'``. m does not matter: TMA zero-fills the ragged last row tile
    and the epilogue does not store it."""
    if dtype == torch.float32:
        return 'f32'
    if (k % WGMMA_MULTIPLE == 0 and n % WGMMA_MULTIPLE == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return 'wgmma'
    return 'wmma'


def rmsnorm_ref(x, gamma):
    """l2-normalise * sqrt(C) in float32, cast, then * gamma in the working
    dtype (``axial_attention.py:38-43``, ``taylor_attention.py:63-70``)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).sum(dim=-1, keepdim=True).clamp_min(1e-24))
    return (x32 * inv * (x.shape[-1] ** 0.5)).to(x.dtype) * gamma.to(x.dtype)


def gemm_nt_ref(a, w, scaled_cols: int = 0, col_scale: float = 1.0):
    """``a w^T`` accumulated in float32, its first ``scaled_cols`` columns
    times ``col_scale`` in float32, cast once to the dtype of ``a``:
    ``taylor_attention.py:74-76``'s ``(qkv[:, :hd] * scale).astype(x.dtype)``
    with k and v cast unscaled."""
    out = F.linear(a.float(), w.float())
    if scaled_cols:
        # out of place: remat='dots' keeps the product and recomputes this
        out = torch.cat([out[..., :scaled_cols] * col_scale,
                         out[..., scaled_cols:]], dim=-1)
    return out.to(a.dtype)


def rmsnorm(x, gamma):
    """Row RMSNorm of ``(rows, C)`` (see ``rmsnorm_ref``); on the card C
    is even (the kernel reads pairs)."""
    if not x.is_cuda:
        return rmsnorm_ref(x, gamma)
    _build.check_cuda_inputs('rmsnorm', x, (gamma,))
    rows, c = x.shape
    if c % 2:
        raise ValueError(f'rmsnorm: C = {c} is odd')
    x, gamma = (t.contiguous() if t.data_ptr() % 8 == 0 else t.clone()
                for t in (x, gamma.to(x.dtype)))
    out = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(lib, lib.mv2_rmsnorm(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), _build.dtype_code(x),
        rows, c, _build.stream_handle(x.device)), 'rmsnorm')
    LAUNCHES['rmsnorm'] += 1
    return out


def gemm_nt(a, w, route: str | None = None, scaled_cols: int = 0,
            col_scale: float = 1.0):
    """``C (m, n) = a (m, k) w (n, k)^T`` in float32 accumulation, the first
    ``scaled_cols`` columns (an even count) times ``col_scale``, cast once
    to ``a``'s dtype. ``route`` overrides :func:`gemm_route` (to time one
    route against another); the kernel raises if the call does not fit it."""
    if not a.is_cuda:
        return gemm_nt_ref(a, w, scaled_cols, col_scale)
    _build.check_cuda_inputs('gemm_nt', a, (w,))
    a = a.contiguous()
    w = w.to(a.dtype).contiguous()
    (m, k), n = a.shape, w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f'gemm_nt: a {tuple(a.shape)} and w '
                         f'{tuple(w.shape)} do not share k')
    route = route or gemm_route(n, k, a.dtype, a, w)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.load_library()
    code = lib.mv2_gemm_nt(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), _build.dtype_code(a), m,
        n, k, ROUTES[route], scaled_cols, float(col_scale),
        _build.stream_handle(a.device))
    _build.check(lib, code, f'gemm_nt ({m}, {n}, {k}) route {route}')
    LAUNCHES[f'gemm_{route}'] += 1
    return out
