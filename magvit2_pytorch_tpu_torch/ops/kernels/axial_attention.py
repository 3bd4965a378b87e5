"""Pre-norm softmax attention block with learned memory KV: space (over the
pixels of a frame) and time (causal over the frames of a pixel).

Replaces the TPU kernels ``magvit2_pytorch_tpu/ops/pallas/axial_attention.py``
``_kernel`` (``fused_attention_block``, :145) and ``_time_kernel``
(``fused_time_attention_block``, :316). Both compute

    RMSNorm(gamma) -> x Wqkv -> per-head softmax attention over the sequence
    plus M memory keys in one joint softmax (optionally causal) -> Wout

with no residual. The CUDA version (``csrc/attention_block.cu``) runs it as
four launches on scratch the wrapper allocates: a row RMSNorm, the qkv GEMM,
an attention pass with one thread per query (online softmax in float32 over
the memory keys and the visible sequence keys, read straight from the qkv
rows), and the out GEMM. The time block uses the same launches: only the
row each (group, position) maps to changes, so ``(B, T, S, C)`` is attended
over t with no transpose and no masked (T*S)^2 tile.

What bounds it on the H100: at the flagship shapes (space: 160 frames x 256
tokens x 512 channels at batch 8; time: 2048 pixels x 5 frames) about 80% of
the FLOPs are the two projections. In bf16 they run on the tensor cores
(WMMA ``mma.sync``, 64x64 tiles, no load pipelining), in float32 on the CUDA
cores — compute-bound either way, well below the card's bf16 rate. The
attention pass reads each key once per query from L1 (all threads of a warp
read the same key), so it is bound by FMA issue, not by device memory; its
scratch (xn, qkv, attn) costs ~3 extra passes over the activation. Fusing the
four launches and ``wgmma``/TMA projections are later work.

On the CPU the wrappers run the plain versions below. On a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.attend import attend_with_memory
from magvit2_pytorch_tpu_torch.ops.kernels import _build

# launches of each CUDA kernel since the last reset (see ops/kernels)
LAUNCHES = {'space_attention_block': 0, 'time_attention_block': 0}

SUPPORTED_DIM_HEAD = (32,)    # csrc/attention_block.cu template cases


def _block_takes(dim_head: int, dropout: float, use_rotary: bool,
                 has_mask: bool) -> bool:
    """What both block gates share: plain axial attention (no dropout,
    rotary or mask) at a head size the CUDA kernel takes, unless
    ``MAGVIT2_TPU_NO_FUSED_ATTN=1`` (read at call time)."""
    if os.environ.get('MAGVIT2_TPU_NO_FUSED_ATTN', '') == '1':
        return False
    return (not (dropout > 0 or use_rotary or has_mask)
            and dim_head in SUPPORTED_DIM_HEAD)


def fused_eligible(n: int, c: int, heads: int, dim_head: int, *,
                   dropout: float, use_rotary: bool,
                   has_mask: bool = False) -> bool:
    """Static gate of the space block (the port's copy of
    ``axial_attention.py:126-141``, under its signature): plain axial
    attention (no dropout, rotary or mask) at ``n <= 1024``, unless
    ``MAGVIT2_TPU_NO_FUSED_ATTN=1`` (read at call time). The TPU-only
    conditions (``n % 8``, lane-multiple ``c`` and ``heads * dim_head``, a
    TPU backend) give way to what the CUDA kernel takes: ``dim_head in
    SUPPORTED_DIM_HEAD``, so ``c`` and ``heads`` decide nothing here. The
    gate does not look at the device, so a module routes the same way on the
    CPU and the card; an ineligible module takes the general path of
    ``ops/attention.py``."""
    return n <= 1024 and _block_takes(dim_head, dropout, use_rotary, has_mask)


def fused_time_eligible(t: int, s: int, c: int, heads: int, dim_head: int, *,
                        dropout: float, use_rotary: bool,
                        has_mask: bool = False) -> bool:
    """Static gate of the time block (``axial_attention.py:296-312``): as
    :func:`fused_eligible` with ``t <= 16``; the TPU's ``s % 16`` tile
    condition is dropped (the CUDA kernel takes any ``s``)."""
    return t <= 16 and _block_takes(dim_head, dropout, use_rotary, has_mask)


def _rmsnorm(x, gamma):
    """l2-normalise * sqrt(C) in float32, cast, then * gamma in the working
    dtype (``axial_attention.py:38-43``)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).sum(dim=-1, keepdim=True) + 1e-24)
    out32 = x32 * inv * (x.shape[-1] ** 0.5)
    return out32.to(x.dtype) * gamma.to(x.dtype)


def attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads: int,
                        dim_head: int, causal: bool = False):
    """Plain version on ``(BT, N, C)``. gamma ``(C,)``, wqkv
    ``(3 * heads * dim_head, C)``, mem_kv ``(2, heads, M, dim_head)``, wout
    ``(C, heads * dim_head)``."""
    dt = x.dtype
    bt, n, _ = x.shape
    xn = _rmsnorm(x, gamma)
    qkv = F.linear(xn, wqkv.to(dt)).reshape(bt, n, 3, heads, dim_head)
    out = attend_with_memory(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             mem_kv[0].to(dt), mem_kv[1].to(dt),
                             causal=causal)
    return F.linear(out.reshape(bt, n, heads * dim_head), wout.to(dt))


def time_attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads: int,
                             dim_head: int, causal: bool = True):
    """Plain version on ``(B, T, S, C)``: attention over t for each s."""
    b, t, s, c = x.shape
    xt = x.permute(0, 2, 1, 3).reshape(b * s, t, c)
    o = attention_block_ref(xt, gamma, wqkv, mem_kv, wout, heads, dim_head,
                            causal=causal)
    return o.reshape(b, s, t, c).permute(0, 2, 1, 3)


def _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal, *,
            groups, L, inner_groups, outer_stride, pos_stride, name):
    _build.check_cuda_inputs(name, x, (gamma, wqkv, mem_kv, wout))
    if dim_head not in SUPPORTED_DIM_HEAD:
        raise ValueError(f'{name}: dim_head {dim_head} not in '
                         f'{SUPPORTED_DIM_HEAD}')
    dt = x.dtype
    c = x.shape[-1]
    inner = heads * dim_head
    m = mem_kv.shape[2]
    x = x.contiguous()
    gamma = gamma.to(dt).contiguous()
    wqkv = wqkv.to(dt).contiguous()
    mem_k = mem_kv[0].to(dt).contiguous()
    mem_v = mem_kv[1].to(dt).contiguous()
    wout = wout.to(dt).contiguous()
    if wqkv.shape != (3 * inner, c) or wout.shape != (c, inner):
        raise ValueError(f'{name}: wqkv {tuple(wqkv.shape)} / wout '
                         f'{tuple(wout.shape)} do not fit C={c}, '
                         f'heads*dim_head={inner}')
    rows = x.numel() // c
    out = torch.empty_like(x)
    xn = torch.empty_like(x)
    qkv = torch.empty((rows, 3 * inner), dtype=dt, device=x.device)
    attn = torch.empty((rows, inner), dtype=dt, device=x.device)
    lib = _build.load_library()
    code = lib.mv2_attention_block(
        x.data_ptr(), gamma.data_ptr(), wqkv.data_ptr(), mem_k.data_ptr(),
        mem_v.data_ptr(), wout.data_ptr(), out.data_ptr(), xn.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), _build.dtype_code(x), rows, c,
        heads, dim_head, m, groups, L, inner_groups, outer_stride, pos_stride,
        int(causal), _build.stream_handle(x.device))
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out


def attention_block(x, gamma, wqkv, mem_kv, wout, heads: int, dim_head: int,
                    causal: bool = False):
    """Space attention block on ``(BT, N, C)`` (see ``attention_block_ref``)."""
    if not x.is_cuda:
        return attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                   dim_head, causal)
    bt, n, _ = x.shape
    return _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                   groups=bt, L=n, inner_groups=1, outer_stride=n,
                   pos_stride=1, name='space_attention_block')


def time_attention_block(x, gamma, wqkv, mem_kv, wout, heads: int,
                         dim_head: int, causal: bool = True):
    """Time attention block on ``(B, T, S, C)``: for each (b, s), attention
    over t (see ``time_attention_block_ref``)."""
    if not x.is_cuda:
        return time_attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                        dim_head, causal)
    b, t, s, _ = x.shape
    # group g = b * S + s; position i = t; row = (b * T + t) * S + s
    return _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                   groups=b * s, L=t, inner_groups=s, outer_stride=t * s,
                   pos_stride=s, name='time_attention_block')
