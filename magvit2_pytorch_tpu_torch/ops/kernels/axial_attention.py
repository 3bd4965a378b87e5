"""Pre-norm softmax attention block with learned memory KV: space (over the
pixels of a frame) and time (causal over the frames of a pixel).

Replaces the TPU kernels ``magvit2_pytorch_tpu/ops/pallas/axial_attention.py``
``_kernel`` (``fused_attention_block``, :145) and ``_time_kernel``
(``fused_time_attention_block``, :316). Both compute

    RMSNorm(gamma) -> x Wqkv -> per-head softmax attention over the sequence
    plus M memory keys in one joint softmax (optionally causal) -> Wout

with no residual. The CUDA version makes four launches on scratch the
wrapper allocates (:func:`block_launches`): the row RMSNorm and the qkv GEMM
of ``csrc/gemm.cu``, an attention core of ``csrc/attention_block.cu``
(online softmax in float32 over the memory keys and the visible sequence
keys, read straight from the qkv rows), and the out GEMM. The time block
uses the same launches: only the row each (group, position) maps to changes
(:func:`group_rows`), so ``(B, T, S, C)`` is attended over t with no
transpose and no masked (T*S)^2 tile.

What bounds it on the H100: operations. The space block at the flagship
shape (160 frames x 256 tokens x 512 channels at batch 8, 8 heads x 32, 4
memory keys) is 53.8 GFLOP: 42.9 in the two projections, 10.9 in the
attention (scores and values over 260 keys), 0.0545 ms at 989 TFLOP/s,
against 85 MB of x, output and weights (0.025 ms at 3.35 TB/s). So every
launch runs on the tensor cores in bf16:

- the projections take ``gemm.py``'s ``'wgmma'`` route (TMA + ``wgmma``,
  128x128 tiles, a 3-stage shared-memory ring), counted as ``gemm_wgmma``;
- the space core (``core_route`` ``'mma'``: bf16, ``dim_head`` 32,
  contiguous groups, at most 1280 keys) gives a block of four warps up to
  256 queries of one (frame, head), stages the head's keys once in shared
  memory and runs ``S = Q K^T`` and ``O += P V`` on ``mma.sync`` with the
  online softmax in registers, counted as ``space_attention_core_mma``;
  alone it is bound by bytes (qkv in, attn out: 0.025 ms);
- the time block (t <= 16 keys a query) and float32 keep the core with
  one thread per query on the CUDA cores (``'scalar'``).

The RMSNorm is a separate pass, bound by bytes like the core. Left for
later: fusing the four launches (the xn, qkv and attn scratch cost ~3
extra passes over the activation), warp specialisation and persistent
tiles in the GEMM, and a tensor-core core for the time block.

On the CPU the wrappers run the plain versions below. On a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.attend import attend_with_memory
from magvit2_pytorch_tpu_torch.ops.kernels import _build, gemm

# launches of each block, and of the tensor-core core, since the last reset
# (see ops/kernels); the blocks' GEMMs count in gemm.LAUNCHES
LAUNCHES = {'space_attention_block': 0, 'time_attention_block': 0,
            'space_attention_core_mma': 0}

SUPPORTED_DIM_HEAD = (32,)    # csrc/attention_block.cu template cases
CORES = {'scalar': 0, 'mma': 1}     # csrc/attention_block.cu CoreRoute
MMA_MAX_KEYS = 1280                 # kMmaMaxKeys: K and V in shared memory


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


def attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads: int,
                        dim_head: int, causal: bool = False):
    """Plain version on ``(BT, N, C)``. gamma ``(C,)``, wqkv
    ``(3 * heads * dim_head, C)``, mem_kv ``(2, heads, M, dim_head)``, wout
    ``(C, heads * dim_head)``."""
    dt = x.dtype
    bt, n, _ = x.shape
    xn = gemm.rmsnorm_ref(x, gamma)
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


def core_route(dtype, dim_head: int, keys: int, inner_groups: int,
               pos_stride: int) -> str:
    """The attention core of a block call: ``'mma'`` (tensor cores) for
    bf16 at ``dim_head`` 32 over contiguous groups (the space block) with at
    most ``MMA_MAX_KEYS`` keys a query, memory keys included; ``'scalar'``
    (one thread per query) otherwise."""
    if (dtype == torch.bfloat16 and dim_head == 32 and inner_groups == 1
            and pos_stride == 1 and keys <= MMA_MAX_KEYS):
        return 'mma'
    return 'scalar'


def group_rows(groups: int, L: int, inner_groups: int, outer_stride: int,
               pos_stride: int, device=None):
    """``(groups, L)``: the row of position i of group g, as the cores map
    it (``csrc/attention_block.cu``)."""
    g = torch.arange(groups, device=device)
    base = (g // inner_groups) * outer_stride + g % inner_groups
    return base[:, None] + torch.arange(L, device=device) * pos_stride


def attention_core_ref(qkv, mem_k, mem_v, heads: int, dim_head: int,
                       causal: bool, *, groups, L, inner_groups,
                       outer_stride, pos_stride):
    """Plain version of :func:`attention_core`: the groups gathered from
    their rows, ``attend_with_memory``, scattered back."""
    rows = group_rows(groups, L, inner_groups, outer_stride, pos_stride,
                      qkv.device)
    q, k, v = qkv[rows].view(groups, L, 3, heads, dim_head).unbind(2)
    out = attend_with_memory(q, k, v, mem_k, mem_v, causal=causal)
    attn = qkv.new_empty((qkv.shape[0], heads * dim_head))
    attn[rows.flatten()] = out.reshape(groups * L, heads * dim_head)
    return attn


def attention_core(qkv, mem_k, mem_v, heads: int, dim_head: int,
                   causal: bool, *, groups, L, inner_groups, outer_stride,
                   pos_stride):
    """The attention step of a block: qkv ``(rows, 3 * heads * dim_head)``
    to attn ``(rows, heads * dim_head)``, mem_k and mem_v ``(heads, M,
    dim_head)``; on the card on the core :func:`core_route` picks."""
    layout = dict(groups=groups, L=L, inner_groups=inner_groups,
                  outer_stride=outer_stride, pos_stride=pos_stride)
    if not qkv.is_cuda:
        return attention_core_ref(qkv, mem_k, mem_v, heads, dim_head, causal,
                                  **layout)
    m = mem_k.shape[1]
    route = core_route(qkv.dtype, dim_head, m + L, inner_groups, pos_stride)
    mem_k, mem_v = ((t if t.data_ptr() % 16 == 0 else t.clone())
                    for t in (mem_k, mem_v))    # cp.async takes 16 bytes
    attn = torch.empty((qkv.shape[0], heads * dim_head), dtype=qkv.dtype,
                       device=qkv.device)
    lib = _build.load_library()
    code = lib.mv2_attention_core(
        qkv.data_ptr(), mem_k.data_ptr(), mem_v.data_ptr(), attn.data_ptr(),
        _build.dtype_code(qkv), groups, L, heads, dim_head, m, inner_groups,
        outer_stride, pos_stride, int(causal), CORES[route],
        _build.stream_handle(qkv.device))
    _build.check(lib, code, f'attention core ({route})')
    if route == 'mma':
        LAUNCHES['space_attention_core_mma'] += 1
    return attn


def space_layout(x) -> dict:
    """The groups of the space block on ``(BT, N, C)``: one a frame, row
    g * N + i."""
    bt, n, _ = x.shape
    return dict(groups=bt, L=n, inner_groups=1, outer_stride=n, pos_stride=1)


def time_layout(x) -> dict:
    """The groups of the time block on ``(B, T, S, C)``: g = b * S + s,
    position t at row (b * T + t) * S + s, so t is attended with no
    transpose."""
    b, t, s, _ = x.shape
    return dict(groups=b * s, L=t, inner_groups=s, outer_stride=t * s,
                pos_stride=s)


def block_launches(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                   **layout):
    """The four launches of a block on ``x (..., C)``: RMSNorm, the qkv
    GEMM, the attention core over the groups ``layout`` describes (see
    :func:`group_rows`), the out GEMM. On CPU tensors each takes its plain
    version, so the composition is testable there."""
    dt = x.dtype
    c = x.shape[-1]
    xn = gemm.rmsnorm(x.reshape(-1, c), gamma)
    qkv = gemm.gemm_nt(xn, wqkv.to(dt))
    attn = attention_core(
        qkv, mem_kv[0].to(dt).contiguous(), mem_kv[1].to(dt).contiguous(),
        heads, dim_head, causal, **layout)
    return gemm.gemm_nt(attn, wout.to(dt)).reshape(x.shape)


def _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal, *, name,
            **layout):
    _build.check_cuda_inputs(name, x, (gamma, wqkv, mem_kv, wout))
    if dim_head not in SUPPORTED_DIM_HEAD:
        raise ValueError(f'{name}: dim_head {dim_head} not in '
                         f'{SUPPORTED_DIM_HEAD}')
    c = x.shape[-1]
    inner = heads * dim_head
    if wqkv.shape != (3 * inner, c) or wout.shape != (c, inner):
        raise ValueError(f'{name}: wqkv {tuple(wqkv.shape)} / wout '
                         f'{tuple(wout.shape)} do not fit C={c}, '
                         f'heads*dim_head={inner}')
    out = block_launches(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                         causal, **layout)
    LAUNCHES[name] += 1
    return out


def attention_block(x, gamma, wqkv, mem_kv, wout, heads: int, dim_head: int,
                    causal: bool = False):
    """Space attention block on ``(BT, N, C)`` (see ``attention_block_ref``)."""
    if not x.is_cuda:
        return attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                   dim_head, causal)
    return _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                   name='space_attention_block', **space_layout(x))


def time_attention_block(x, gamma, wqkv, mem_kv, wout, heads: int,
                         dim_head: int, causal: bool = True):
    """Time attention block on ``(B, T, S, C)``: for each (b, s), attention
    over t (see ``time_attention_block_ref``)."""
    if not x.is_cuda:
        return time_attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                        dim_head, causal)
    return _launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                   name='time_attention_block', **time_layout(x))
