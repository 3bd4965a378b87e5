"""Pre-norm softmax attention block with learned memory KV: space (over the
pixels of a frame) and time (causal over the frames of a pixel).

Replaces the TPU kernels ``magvit2_pytorch_tpu/ops/pallas/axial_attention.py``
``_kernel`` (``fused_attention_block``, :145) and ``_time_kernel``
(``fused_time_attention_block``, :316). Both compute

    RMSNorm(gamma) -> x Wqkv -> per-head softmax attention over the sequence
    plus M memory keys in one joint softmax (optionally causal) -> Wout

with no residual.

The space block makes four launches on scratch the wrapper allocates
(:func:`block_launches`): the row RMSNorm and the qkv GEMM of
``csrc/gemm.cu``, an attention core of ``csrc/attention_block.cu`` (online
softmax in float32 over the memory keys and the visible sequence keys, read
straight from the qkv rows), and the out GEMM. What bounds it on the H100:
operations. At the flagship shape (160 frames x 256 tokens x 512 channels
at batch 8, 8 heads x 32, 4 memory keys) it is 53.8 GFLOP: 42.9 in the two
projections, 10.9 in the attention (scores and values over 260 keys),
0.0545 ms at 989 TFLOP/s, against 85 MB of x, output and weights (0.025 ms
at 3.35 TB/s). So every launch runs on the tensor cores in bf16:

- the projections take ``gemm.py``'s ``'wgmma'`` route (TMA + ``wgmma``,
  128x128 tiles, a 3-stage shared-memory ring), counted as ``gemm_wgmma``;
- the space core (``core_route`` ``'mma'``: bf16, ``dim_head`` 32,
  contiguous groups, at most 1280 keys) gives a block of four warps up to
  256 queries of one (frame, head), stages the head's keys once in shared
  memory and runs ``S = Q K^T`` and ``O += P V`` on ``mma.sync`` with the
  online softmax in registers, counted as ``space_attention_core_mma``;
  alone it is bound by bytes (qkv in, attn out: 0.025 ms).

The time block on ``(B, T, S, C)`` takes one of two routes
(:func:`time_block_route`, decided from shapes and passed to C):

- ``'fused'`` (bf16, ``dim_head`` 32, T <= 16, C <= 512, heads * dim_head
  <= 256, M <= 4): one launch of ``csrc/time_attention.cu``. A block owns
  one batch index and P <= 60 // T consecutive pixels over all T frames
  (:func:`time_block_pixels`), reads x once, keeps the normed x, qkv and
  the attention output in shared memory and writes the output once; the
  projections run on ``wgmma`` and each (pixel, head) attends over its own
  T frames on the CUDA cores with ``_time_kernel``'s cast points. At the
  flagship shape (8, 5, 256, 512) it is 10.7 GFLOP (0.0109 ms at the bf16
  peak) against 22 MB (0.0066 ms): operations bound it. Each block
  streams the ~1 MB of weights from L2, and the tile is chosen to keep
  that stream ahead of the tensor cores (:func:`time_block_pixels`; the
  kernel's launcher takes the deepest weight ring that then fits,
  :func:`time_block_plan`).
- ``'launches'`` (float32, and bf16 shapes the fused tile does not take):
  the space block's four launches on the time layout (:func:`group_rows`:
  t attended with no transpose) with the scalar core, one thread per
  query on the CUDA cores.

On the CPU the wrappers run the plain versions below, and autograd
differentiates them. On a CUDA tensor they launch the kernel or raise; their
backward recomputes through the plain version that mirrors the JAX custom
VJP's XLA twin (``_Block``), as the JAX package's backward does: there is no
backward kernel in the JAX package to port for these blocks.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.attend import attend_with_memory
from magvit2_pytorch_tpu_torch.ops.kernels import _build, gemm

# launches of each block, and of the tensor-core core, since the last reset
# (see ops/kernels); the blocks' GEMMs count in gemm.LAUNCHES
LAUNCHES = {'space_attention_block': 0, 'time_attention_block': 0,
            'space_attention_core_mma': 0, 'time_attention_block_fused': 0,
            'time_attention_block_launches': 0,
            'space_attention_block_backward': 0,
            'time_attention_block_backward': 0}

SUPPORTED_DIM_HEAD = (32,)    # csrc/attention_block.cu template cases
CORES = {'scalar': 0, 'mma': 1}     # csrc/attention_block.cu CoreRoute
MMA_MAX_KEYS = 1280                 # kMmaMaxKeys: K and V in shared memory
TIME_ROUTES = {'launches': 0, 'fused': 1}   # csrc/time_attention.cu TimeRoute
# the shapes the fused time block takes (csrc/time_attention.cu
# kTbMax*, whose launcher refuses any other): rows a block owns, frames,
# memory keys, channels and heads * dim_head
TIME_MAX_ROWS, TIME_MAX_T, TIME_MAX_MEM = 60, 16, 4
TIME_MAX_C, TIME_MAX_INNER = 512, 256


def _block_takes(dim_head: int, dropout: float, use_rotary: bool,
                 has_mask: bool, has_cond: bool, streaming: bool) -> bool:
    """What both block gates share: plain axial attention (no dropout,
    rotary, mask, conditioning or stream) at a head size the CUDA kernel
    takes, unless ``MAGVIT2_TPU_NO_FUSED_ATTN=1`` (read at call time)."""
    if os.environ.get('MAGVIT2_TPU_NO_FUSED_ATTN', '') == '1':
        return False
    return (not (dropout > 0 or use_rotary or has_mask or has_cond
                 or streaming)
            and dim_head in SUPPORTED_DIM_HEAD)


def fused_eligible(n: int, c: int, heads: int, dim_head: int, *,
                   dropout: float, use_rotary: bool,
                   has_mask: bool = False, has_cond: bool = False,
                   streaming: bool = False) -> bool:
    """Static gate of the space block (the port's copy of
    ``axial_attention.py:126-141``, under its signature): plain axial
    attention (no dropout, rotary, mask, cond or stream) at ``n <= 1024``,
    unless
    ``MAGVIT2_TPU_NO_FUSED_ATTN=1`` (read at call time). The TPU-only
    conditions (``n % 8``, lane-multiple ``c`` and ``heads * dim_head``, a
    TPU backend) give way to what the CUDA kernel takes: ``dim_head in
    SUPPORTED_DIM_HEAD``, so ``c`` and ``heads`` decide nothing here. The
    gate does not look at the device, so a module routes the same way on the
    CPU and the card; an ineligible module takes the general path of
    ``ops/attention.py``."""
    return n <= 1024 and _block_takes(dim_head, dropout, use_rotary,
                                      has_mask, has_cond, streaming)


def fused_time_eligible(t: int, s: int, c: int, heads: int, dim_head: int, *,
                        dropout: float, use_rotary: bool,
                        has_mask: bool = False, has_cond: bool = False,
                        streaming: bool = False) -> bool:
    """Static gate of the time block (``axial_attention.py:296-312``): as
    :func:`fused_eligible` with ``t <= 16``; the TPU's ``s % 16`` tile
    condition is dropped (the CUDA kernel takes any ``s``)."""
    return t <= 16 and _block_takes(dim_head, dropout, use_rotary,
                                    has_mask, has_cond, streaming)


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


def time_core_ref(qkv, mem_k, mem_v, heads: int, dim_head: int,
                  causal: bool = True):
    """The attention step of the time block with ``_time_kernel``'s cast
    points (``axial_attention.py:252-272``): qkv ``(B, T, S, 3 * heads *
    dim_head)`` to ``(B, T, S, heads * dim_head)``, mem_k and mem_v
    ``(heads, M, dim_head)``. Scores in float32 times ``dim_head ** -0.5``,
    one max over the memory keys and the visible frames, e and den in
    float32, e rounded to the working dtype before the products with v and
    mem_v, those summed in float32, ``o / den`` cast once."""
    dt = qkv.dtype
    b, t, s, _ = qkv.shape
    q, k, v = qkv.view(b, t, s, 3, heads, dim_head).float().unbind(3)
    scale = dim_head ** -0.5
    dots = torch.einsum('btshd,bushd->bshtu', q, k) * scale
    dots_m = torch.einsum('btshd,hmd->bshtm', q, mem_k.float()) * scale
    if causal:
        hidden = torch.ones(t, t, dtype=torch.bool,
                            device=qkv.device).triu(1)
        dots = dots.masked_fill(hidden, torch.finfo(torch.float32).min)
    mx = torch.maximum(dots.amax(-1), dots_m.amax(-1))[..., None]
    e, e_m = torch.exp(dots - mx), torch.exp(dots_m - mx)
    den = e.sum(-1) + e_m.sum(-1)                               # (b, s, h, t)
    o = (torch.einsum('bshtu,bushd->bshtd', e.to(dt).float(), v)
         + torch.einsum('bshtm,hmd->bshtd', e_m.to(dt).float(),
                        mem_v.float()))
    o = (o / den[..., None]).to(dt)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, s, heads * dim_head)


def time_attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads: int,
                             dim_head: int, causal: bool = True):
    """Plain version on ``(B, T, S, C)``: attention over t for each s, with
    ``_time_kernel``'s cast points (the normed x, qkv, e and the attention
    output rounded to the working dtype; float32 sums)."""
    dt = x.dtype
    qkv = gemm.gemm_nt_ref(gemm.rmsnorm_ref(x, gamma), wqkv.to(dt))
    attn = time_core_ref(qkv, mem_kv[0].to(dt), mem_kv[1].to(dt), heads,
                         dim_head, causal)
    return gemm.gemm_nt_ref(attn, wout.to(dt))


def time_block_pixels(b: int, t: int, s: int, sms: int) -> int:
    """Pixels a block of the fused time block owns (over all t frames, so
    ``t * P <= TIME_MAX_ROWS`` rows): the fewest that keep the launch at its
    least number of waves over the card's ``sms`` SMs (one block an SM).
    A block's time is mostly its stream of the weights, the same whatever
    its rows, so fewer rows cost nothing within a wave and leave shared
    memory to a deeper weight ring. The flagship's (8, 5, 256) on 132 SMs:
    8 pixels, 256 blocks in two waves, where the most, 12, gives 176
    blocks, two waves too."""
    p_max = TIME_MAX_ROWS // t

    def waves(p):
        return -(-b * -(-s // p) // sms)

    least = waves(p_max)
    return next(p for p in range(1, p_max + 1) if waves(p) == least)


def time_block_route(dtype, t: int, s: int, c: int, heads: int,
                     dim_head: int, m: int, *tensors) -> str:
    """The time block's route: ``'fused'`` (one launch of
    ``csrc/time_attention.cu``) for bf16 at ``dim_head`` 32, 1 <= t <=
    ``TIME_MAX_T``, C and heads * dim_head multiples of 64 up to
    ``TIME_MAX_C`` and ``TIME_MAX_INNER`` (where the kernel's shared memory
    holds two weight stages at any rows, memory keys and pixel count it
    takes), at most ``TIME_MAX_MEM`` memory keys, and every tensor given
    (x, wqkv, wout, which TMA reads, and gamma and mem_kv, read in 16-byte
    pieces) starting 16-byte aligned (the rows then are too);
    ``'launches'`` (four launches, the scalar core) otherwise. s does not
    enter: the last tile of a batch index is masked."""
    inner = heads * dim_head
    if (dtype == torch.bfloat16 and dim_head == 32
            and 1 <= t <= TIME_MAX_T and s >= 1
            and 0 < c <= TIME_MAX_C and c % 64 == 0
            and 0 < inner <= TIME_MAX_INNER and inner % 64 == 0
            and 0 <= m <= TIME_MAX_MEM
            and all(x.data_ptr() % 16 == 0 for x in tensors)):
        return 'fused'
    return 'launches'


def time_block_plan(t: int, pixels: int, c: int, heads: int, m: int):
    """What the fused kernel's launcher plans for a call (``dim_head`` 32):
    ``{'stages': ..., 'dynamic_smem_bytes': ...}``, its weight ring's depth
    and the dynamic shared memory it asks for, or None where it does not
    take the shape. Calls the built library (the card's)."""
    out = (ctypes.c_int * 2)()
    lib = _build.load_library()
    if lib.mv2_time_block_plan(t, pixels, c, heads, m, out) != 0:
        return None
    return dict(stages=out[0], dynamic_smem_bytes=out[1])


def time_block_attributes() -> dict:
    """What the CUDA runtime reports for the fused time block's kernel:
    registers and local (spilled) bytes a thread, static shared memory, and
    the dynamic shared memory its launcher last set (on every launch)."""
    out = (ctypes.c_int * 4)()
    lib = _build.load_library()
    _build.check(lib, lib.mv2_time_block_attributes(out),
                 'time attention block attributes')
    return dict(zip(('registers', 'local_bytes', 'static_smem_bytes',
                     'dynamic_smem_bytes'), out))


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


def _check_block(name, x, gamma, wqkv, mem_kv, wout, heads, dim_head):
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


def _space_block_launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                        causal):
    name = 'space_attention_block'
    _check_block(name, x, gamma, wqkv, mem_kv, wout, heads, dim_head)
    out = block_launches(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                         causal, **space_layout(x))
    LAUNCHES[name] += 1
    return out


class _Block(torch.autograd.Function):
    """A block on the card: the forward launches the kernel; the backward
    recomputes through the plain version that mirrors the JAX custom VJP's
    XLA twin and differentiates that (``axial_attention.py:194-208`` for
    the space block, ``:362-376`` for the time block), as the JAX package
    does. Each backward counts as ``<name>_backward``."""

    @staticmethod
    def forward(ctx, x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal,
                launch, twin, name):
        ctx.save_for_backward(x, gamma, wqkv, mem_kv, wout)
        ctx.args, ctx.twin, ctx.name = (heads, dim_head, causal), twin, name
        return launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head, causal)

    @staticmethod
    def backward(ctx, grad):
        LAUNCHES[f'{ctx.name}_backward'] += 1
        grads = _build.recompute_grads(
            lambda *a: ctx.twin(*a, *ctx.args), ctx.saved_tensors,
            ctx.needs_input_grad[:5], grad)
        return (*grads, None, None, None, None, None, None)


def attention_block(x, gamma, wqkv, mem_kv, wout, heads: int, dim_head: int,
                    causal: bool = False):
    """Space attention block on ``(BT, N, C)`` (see ``attention_block_ref``);
    differentiable on both devices."""
    if not x.is_cuda:
        return attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                   dim_head, causal)
    return _Block.apply(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                        causal, _space_block_launch, attention_block_ref,
                        'space_attention_block')


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def time_block_fused(x, gamma, wqkv, mem_kv, wout, heads: int,
                     dim_head: int, causal: bool):
    """One launch of ``csrc/time_attention.cu`` on bf16 ``x (B, T, S, C)``
    with the parameters in x's dtype, every tensor contiguous; the caller
    has taken :func:`time_block_route`."""
    b, t, s, c = x.shape
    p = time_block_pixels(b, t, s, _sm_count(x.device))
    out = torch.empty_like(x)
    lib = _build.load_library()
    code = lib.mv2_time_attention_block(
        x.data_ptr(), gamma.data_ptr(), wqkv.data_ptr(),
        mem_kv[0].data_ptr(), mem_kv[1].data_ptr(), wout.data_ptr(),
        out.data_ptr(), _build.dtype_code(x), b, t, s, c, heads, dim_head,
        mem_kv.shape[2], p, int(causal),
        TIME_ROUTES['fused'], _build.stream_handle(x.device))
    _build.check(lib, code, f'time attention block {tuple(x.shape)}')
    return out


def time_attention_block_twin(x, gamma, wqkv, mem_kv, wout, heads: int,
                              dim_head: int, causal: bool = True):
    """What the time block's backward differentiates on the card: the port's
    counterpart of ``_time_block_xla`` (``axial_attention.py:278-285``), the
    space block's plain version over each pixel's frames, whose cast points
    are ``attend_with_memory``'s and not ``_time_kernel``'s."""
    b, t, s, c = x.shape
    xt = x.transpose(1, 2).reshape(b * s, t, c)
    out = attention_block_ref(xt, gamma, wqkv, mem_kv, wout, heads,
                              dim_head, causal)
    return out.reshape(b, s, t, c).transpose(1, 2)


def time_attention_block(x, gamma, wqkv, mem_kv, wout, heads: int,
                         dim_head: int, causal: bool = True):
    """Time attention block on ``(B, T, S, C)``: for each (b, s), attention
    over t (see ``time_attention_block_ref``), on the route
    :func:`time_block_route` picks; differentiable on both devices (on the
    card through :func:`time_attention_block_twin`)."""
    if not x.is_cuda:
        return time_attention_block_ref(x, gamma, wqkv, mem_kv, wout, heads,
                                        dim_head, causal)
    return _Block.apply(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                        causal, _time_block_launch, time_attention_block_twin,
                        'time_attention_block')


def _time_block_launch(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                       causal):
    name = 'time_attention_block'
    _check_block(name, x, gamma, wqkv, mem_kv, wout, heads, dim_head)
    dt = x.dtype
    b, t, s, c = x.shape
    x, gamma, wqkv, mem_kv, wout = (a.to(dt).contiguous() for a in
                                    (x, gamma, wqkv, mem_kv, wout))
    route = time_block_route(dt, t, s, c, heads, dim_head, mem_kv.shape[2],
                             x, gamma, wqkv, mem_kv, wout)
    if route == 'fused':
        out = time_block_fused(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                               causal)
    else:
        out = block_launches(x, gamma, wqkv, mem_kv, wout, heads, dim_head,
                             causal, **time_layout(x))
    LAUNCHES[name] += 1
    LAUNCHES[f'{name}_{route}'] += 1
    return out
