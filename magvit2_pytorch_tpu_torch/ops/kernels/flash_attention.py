"""Flash attention, forward and backward: ``softmax(scale q k^T + bias) v``
by an online softmax over key tiles, never holding the ``(n, m)`` scores in
device memory.

Replaces the three TPU kernels of
``magvit2_pytorch_tpu/ops/pallas/flash_attention.py``: ``_flash_kernel``
(:51, the forward, which also gives the per-row logsumexp ``lse``),
``_bwd_dq_kernel`` (:190) and ``_bwd_dkv_kernel`` (:249), with the
decomposition of that file's docstring:

    D  = rowsum(dO * O)                     (elementwise, outside the kernels)
    P  = exp(S - lse);  dV = P^T dO
    dP = dO V^T;  dS = P * (dP - D)
    dQ = scale dS K;  dK = scale dS^T Q;  d_bias = dS

Masking as the TPU kernel does it: keys ``>= m`` and, with ``causal``, keys
``> row + (m - n)`` score ``-1e30`` (right-aligned: with ``m > n`` the
``m - n`` keys in front, the memory keys, are visible to every query). Any
``m >= 1``: with ``causal`` and ``m < n`` the first ``n - m`` rows see no key,
and each gets what the plain ``attend`` gives such a row (its float32
minimum at every key, a uniform softmax): out the mean of v over the m keys,
dq 0, nothing into dk or d_bias, ``dO / m`` into every dv row. The JAX
flash kernel averages its zero-padded keys in too (ROADMAP item C9); the
port follows the plain path.

The CUDA version (``csrc/flash_attention.cu``, its header has the design
and the bound) reads ``(b, h, n, d)`` in place with the ragged last tile
predicated: the TPU wrapper's padded copies and its ``(bh, 1, n_pad)`` lse
are not carried over, ``lse`` is ``(b, h, n)`` float32. A bias ``(n, m)``,
``(h, n, m)`` or ``(b, h, n, m)`` is read as slice ``bh % groups`` without
materialising the broadcast; its gradient is written by the dQ kernel as
``(b h, n, m)`` float32 and the groups that shared a slice are summed here,
as the JAX wrapper does outside its kernel. Any head size, as the JAX
kernel takes any head (its block is the whole head): the kernels take a
multiple of 8, run it up to :data:`NARROW_MAX` at the next of the padded
:data:`WIDTHS` and above on the wide kernels (the output in column chunks
of 256, one a block, the scores summed over column slices; in bf16 all
three up to :data:`WG_WIDE_MAX` on the Hopper wide kernels, whose two
consumer warpgroups split the output columns; dK/dV and dQ form their
scores once a block from their two partial sums; all three up to
:data:`WG_PAIR_MAX` on clusters of two such blocks that split the head and
sum their partial scores across the pair), and
:func:`flash_attention` pads any other head with zero columns up to the next
multiple of 8 (on the CPU too). float32 (CUDA cores, no TF32) and bfloat16
(tensor cores). All three kernels take the
route of :func:`flash_route`: ``'mma'`` for bf16, kernels with register
accumulators (the forward's online softmax in them too) and the causal tile
skip (:func:`dq_key_tiles`, :func:`dkv_query_tiles`, :func:`tile_masked`):
up to 64 on ``mma.sync`` behind a ``cp.async`` ring, and at the widths 128
and 256 all three on ``wgmma`` fed by TMA, a producer warpgroup and two
consumer warpgroups (:data:`WG_FWD_ROWS`, :data:`WG_FWD_TILE`,
:data:`WG_DQ_ROWS`, :data:`WG_DQ_TILE`, :data:`WG_DKV_KEYS`,
:data:`WG_DKV_TILE`); ``'f32'`` for float32, on the CUDA cores.

:func:`flash_attention` is a ``torch.autograd.Function``: the forward
launches one kernel and saves ``q, k, v, bias, out, lse``, the backward
launches two. On CPU tensors the same Function runs the plain forward and
the plain backward below, so the CPU tests go through the same autograd
wiring. On a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from magvit2_pytorch_tpu_torch.ops.attend import causal_hidden
from magvit2_pytorch_tpu_torch.ops.kernels import _build

# launches of each CUDA kernel since the last reset (see ops/kernels), and
# of each kernel by route
KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dkv')
ROUTES = {'f32': 0, 'mma': 1}         # csrc/flash_attention.cu Route
LAUNCHES = {**dict.fromkeys(KERNELS, 0),
            **{f'{kernel}_{route}': 0 for kernel in KERNELS
               for route in ROUTES}}

WIDTHS = (16, 32, 64, 128, 256)       # csrc/flash_attention.cu head_width
EXACT_WIDTH = 64                      # kExactWidth: built apart at d == D
# the Hopper kernels above EXACT_WIDTH (csrc/flash_attention.cu WgFwdGeo,
# WgDqGeo, WgDkvGeo), by padded width: query rows a forward block, keys a
# forward tile, query rows a dQ block, keys a dQ tile, keys a dK/dV block
# and queries a dK/dV tile
WG_FWD_ROWS = 128
WG_FWD_TILE = {128: 128, 256: 64}
WG_DQ_ROWS = 128
WG_DQ_TILE = {128: 64, 256: 32}
WG_DKV_KEYS = {128: 128, 256: 64}
WG_DKV_TILE = 64
NARROW_MAX = 256                      # kNarrowMax: wider heads, wide kernels
WIDE_OUT = 256                        # kWideOut: output columns a block
# the Hopper wide forward, dQ and dK/dV ('mma', heads of NARROW_MAX + 1 to
# WG_WIDE_MAX; csrc/flash_attention.cu WgWideFwdGeo, WgWideDqGeo,
# WgWideDkvGeo): query rows a forward block, keys a forward tile, query rows
# a dQ block, keys a dQ tile, keys a dK/dV block, queries a dK/dV tile, and
# whether each kernel sums its scores from the two consumer warpgroups'
# partial products (else each warpgroup forms them whole); each consumer
# warpgroup owns WG_WIDE_HALF output columns
WG_WIDE_MAX = 512                     # kWgWideMax
WG_WIDE_HALF = WG_WIDE_MAX // 2       # kWgWideHalf
WG_WIDE_FWD_ROWS = 64
WG_WIDE_FWD_TILE = 32
WG_WIDE_FWD_EXCHANGE = False
WG_WIDE_DQ_ROWS = 64
WG_WIDE_DQ_TILE = 32
WG_WIDE_DQ_EXCHANGE = True
WG_WIDE_DKV_KEYS = 64
WG_WIDE_DKV_TILE = 16
WG_WIDE_DKV_EXCHANGE = True
# the three kernels at heads of WG_WIDE_MAX + 1 to WG_PAIR_MAX ('mma';
# csrc/flash_attention.cu kWgPairMax, WgPairFwdGeo, WgPairDkvGeo,
# WgPairDqGeo): clusters of WG_PAIR_CLUSTER blocks, each the Hopper wide
# block on WG_WIDE_MAX columns of the head, the scores (and dP) summed
# across the pair through an inbox of the peer's partial sums. The forward
# and dK/dV keep the wide geometry (WG_WIDE_FWD_*, WG_WIDE_DKV_*): the
# forward's two buffers (it sends a tile's partial before it adds the
# peer's of the tile before), dK/dV's one. dQ's block takes keys a tile,
# stages of K's ring and of V's and inbox buffers (sent and added in step)
# of its own.
WG_PAIR_MAX = 2 * WG_WIDE_MAX         # kWgPairMax
WG_PAIR_CLUSTER = 2                   # kPairCluster
WG_PAIR_FWD_BUFFERS = 2
WG_PAIR_DKV_BUFFERS = 1
WG_PAIR_DQ_TILE = 32
WG_PAIR_DQ_K_STAGES = 1
WG_PAIR_DQ_V_STAGES = 1
WG_PAIR_DQ_BUFFERS = 2
MASKED = -1e30


def check_dim_head(dim_head: int):
    """A head of at least one value: the JAX kernel takes any head."""
    if dim_head < 1:
        raise ValueError(f'flash attention: head size {dim_head} < 1')


def flash_route(dtype, dim_head: int) -> str:
    """The kernels of a call, forward and backward: ``'mma'`` (tensor
    cores) for bf16, ``'f32'`` (CUDA cores) for float32, at every head
    size. It does not look at the device; no route gives way to
    another, and what neither takes raises. The route is passed to the C
    entry points, which refuse one that does not fit the dtype."""
    check_dim_head(dim_head)
    if dtype == torch.bfloat16:
        return 'mma'
    if dtype == torch.float32:
        return 'f32'
    raise TypeError(f'flash attention: kernels take float32 or bfloat16, '
                    f'got {dtype}')


# The 'mma' kernels' causal skip, as csrc/flash_attention.cu computes it.
# With causal, query row i sees key j where j <= i + (m - n): with m < n,
# rows i < n - m see none.

def dq_key_tiles(q0: int, rows: int, n: int, m: int, causal: bool,
                 tile: int) -> int:
    """The forward or dQ block of query rows ``q0 .. q0 + rows - 1`` visits
    key tiles ``0 .. dq_key_tiles - 1`` of ``tile`` keys: with causal, up to
    the last one its last row sees (none, when that row sees no key)."""
    end = min(m, min(q0 + rows, n) + m - n) if causal else m
    return -(-max(end, 0) // tile)


def dkv_query_tiles(k0: int, n: int, m: int, causal: bool, tile: int):
    """The query tiles of ``tile`` rows that the dK/dV block whose first
    key is ``k0`` visits: with causal, from the first whose last row sees
    ``k0``."""
    first = max(0, k0 - (m - n)) // tile if causal else 0
    return range(first, -(-n // tile))


def tile_masked(q0: int, nq: int, k0: int, nk: int, n: int, m: int,
                causal: bool) -> bool:
    """Whether the tile of query rows ``q0 .. q0 + nq - 1`` and keys
    ``k0 .. k0 + nk - 1`` tests each element: it crosses a ragged edge
    (rows >= n, keys >= m), or with causal its last key lies past its first
    row's diagonal."""
    return (q0 + nq > n or k0 + nk > m
            or (causal and k0 + nk - 1 > q0 + m - n))


def _acc_dtype(t):
    """float32 for float32 and bfloat16, float64 for float64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _logits(q, k, bias, causal: bool, scale: float):
    """Dense masked logits ``(b, h, n, m)`` in the accumulation dtype, and
    the visibility mask (or None). ``bias`` is ``(groups, n, m)``."""
    b, h, n, _ = q.shape
    m = k.shape[-2]
    acc = _acc_dtype(q)
    s = torch.einsum('bhid,bhjd->bhij', q.to(acc), k.to(acc)) * scale
    if bias is not None:
        g = bias.shape[0]
        s = (s.reshape(b * h // g, g, n, m) + bias.to(acc)).reshape(b, h, n, m)
    visible = ~causal_hidden(n, m, q.device) if causal else None
    if visible is not None:
        s = s.masked_fill(~visible, MASKED)
    return s, visible


def no_key_rows(n: int, m: int, causal: bool) -> int:
    """The leading query rows that see no key: ``n - m`` with causal and
    fewer keys than queries, else 0."""
    return max(n - m, 0) if causal else 0


def _no_key_uniform(p, n: int, m: int, causal: bool):
    """P with the rows that see no key at ``1 / m`` on every key: the plain
    ``attend``'s uniform softmax over m masked scores."""
    rows = no_key_rows(n, m, causal)
    if not rows:
        return p
    return torch.cat((torch.full_like(p[..., :rows, :], 1.0 / m),
                      p[..., rows:, :]), dim=-2)


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, bias=None):
    """Plain forward: ``(out, lse)``. q ``(b, h, n, d)``; k, v
    ``(b, h, m, d)``; bias ``(groups, n, m)`` or None. Dense float32 logits,
    the kernel's masking constant, ``lse`` by ``logsumexp``; a row that sees
    no key gets the mean of v (and lse ``-1e30``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    n, m = q.shape[-2], k.shape[-2]
    s, _ = _logits(q, k, bias, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = _no_key_uniform(torch.exp(s - lse[..., None]), n, m, causal)
    out = torch.einsum('bhij,bhjd->bhid', p, v.to(p.dtype))
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, bias, out, lse, dout, causal: bool,
                            scale: float):
    """Plain backward on dense matrices, step by step as the kernels do it:
    ``(dq, dk, dv, dbias)`` with ``dbias`` in the bias's ``(groups, n, m)``
    shape (the groups that shared a slice summed) or None. A row that sees
    no key weighs ``1 / m`` in dv and nothing in dS."""
    b, h, n, _ = q.shape
    m = k.shape[-2]
    acc = _acc_dtype(q)
    s, visible = _logits(q, k, bias, causal, scale)
    p = torch.exp(s - lse[..., None].to(acc))
    if visible is not None:
        p = p.masked_fill(~visible, 0.0)
    do = dout.to(acc)
    delta = (do * out.to(acc)).sum(dim=-1)
    dv = torch.einsum('bhij,bhid->bhjd', _no_key_uniform(p, n, m, causal),
                      do)
    dp = torch.einsum('bhid,bhjd->bhij', do, v.to(acc))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum('bhij,bhjd->bhid', ds, k.to(acc)) * scale
    dk = torch.einsum('bhij,bhid->bhjd', ds, q.to(acc)) * scale
    dbias = None
    if bias is not None:
        dbias = _reduce_bias_groups(ds.reshape(b * h, n, m), bias)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _reduce_bias_groups(ds, bias):
    """dS ``(b h, n, m)`` -> the bias's ``(groups, n, m)``: program ``bh``
    read slice ``bh % groups``, so its cotangent sums those programs."""
    g = bias.shape[0]
    bh, n, m = ds.shape
    if g != bh:
        ds = ds.reshape(bh // g, g, n, m).sum(dim=0)
    return ds.to(bias.dtype)


def _aligned(t):
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(what: str, q, *others):
    for t in others:
        if t is not None and (not t.is_cuda or t.device != q.device):
            raise ValueError(f'{what}: every tensor must be on {q.device}')
    _build.dtype_code(q)


def _geometry(q, k, bias):
    b, h, n, d = q.shape
    m = k.shape[-2]
    groups = bias.shape[0] if bias is not None else 1
    return b * h, n, m, d, groups


def _tail(q, k, bias, causal: bool, scale: float, route: str):
    """The arguments every entry point takes after its pointers."""
    bh, n, m, d, groups = _geometry(q, k, bias)
    return (_build.dtype_code(q), bh, n, m, d, groups, int(causal),
            float(scale), ROUTES[route], _build.stream_handle(q.device))


def _counted(name: str, route: str):
    LAUNCHES[name] += 1
    LAUNCHES[f'{name}_{route}'] += 1


def _kernel_route(name: str, q) -> str:
    """The route of a kernel launch, whose head must be a multiple of 8
    (:func:`flash_attention` pads any other)."""
    route = flash_route(q.dtype, q.shape[-1])
    if q.shape[-1] % 8:
        raise ValueError(f'{name}: head size {q.shape[-1]} is not a multiple '
                         'of 8 (flash_attention pads it)')
    return route


def flash_forward(q, k, v, bias, causal: bool, scale: float):
    """The forward kernel of :func:`flash_route`'s route alone, CUDA tensors
    only: ``(out, lse)`` with ``lse`` ``(b, h, n)`` float32 in natural log;
    bias ``(groups, n, m)`` or None."""
    name = 'flash_attention_fwd'
    _check_cuda(name, q, k, v, bias)
    route = _kernel_route(name, q)
    q, k, v = _aligned(q), _aligned(k.to(q.dtype)), _aligned(v.to(q.dtype))
    bias = None if bias is None else _aligned(bias.to(q.dtype))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    code = lib.mv2_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_tail(q, k, bias, causal, scale, route))
    _build.check(lib, code, f'{name} ({route})')
    _counted(name, route)
    return out, lse


def flash_backward_dq(q, k, v, bias, dout, lse, delta, causal: bool,
                   scale: float, need_dbias: bool = False):
    """The dQ kernel of :func:`flash_route`'s route alone, on prepared
    CUDA tensors (one dtype, contiguous, 16-byte aligned; ``delta`` from
    :func:`row_delta`): ``(dq, ds)`` with ``ds`` the ``(b h, n, m)``
    float32 dS or None."""
    name = 'flash_attention_bwd_dq'
    route = _kernel_route(name, q)
    dq = torch.empty_like(q)
    ds = (torch.empty((q.shape[0] * q.shape[1], q.shape[2], k.shape[2]),
                      dtype=torch.float32, device=q.device)
          if need_dbias else None)
    lib = _build.load_library()
    code = lib.mv2_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        None if ds is None else ds.data_ptr(),
        *_tail(q, k, bias, causal, scale, route))
    _build.check(lib, code, f'{name} ({route})')
    _counted(name, route)
    return dq, ds


def flash_backward_dkv(q, k, v, bias, dout, lse, delta, causal: bool,
                    scale: float):
    """The dK/dV kernel of :func:`flash_route`'s route alone, on
    prepared CUDA tensors: ``(dk, dv)``."""
    name = 'flash_attention_bwd_dkv'
    route = _kernel_route(name, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_library()
    code = lib.mv2_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, bias, causal, scale, route))
    _build.check(lib, code, f'{name} ({route})')
    _counted(name, route)
    return dk, dv


# the 'mma' kernels as mv2_flash_mma_attributes numbers them
MMA_KERNELS = ('dq', 'dkv', 'fwd')


def mma_kernel(kernel: str, width: int, exact: bool = True) -> str:
    """The CUDA kernel that :func:`mma_attributes` reports: up to
    :data:`EXACT_WIDTH` the exact build or (``exact=False``) the padded one;
    at 128 and 256 the Hopper kernels (``*_wg_mma_kernel``) for every head;
    over :data:`NARROW_MAX` the Hopper wide kernels (``*_wg_wide_kernel``)
    up to :data:`WG_WIDE_MAX`, the paired ones (``*_wg_pair_kernel``) up
    to :data:`WG_PAIR_MAX`, and the wide kernels (``*_wide_mma_kernel``)
    for the rest."""
    stem = {'fwd': 'fwd', 'dq': 'bwd_dq', 'dkv': 'bwd_dkv'}[kernel]
    if width > NARROW_MAX:
        if width <= WG_WIDE_MAX:
            return f'{stem}_wg_wide_kernel'
        if width <= WG_PAIR_MAX:
            return f'{stem}_wg_pair_kernel'
        return f'{stem}_wide_mma_kernel'
    if width > EXACT_WIDTH:
        return f'{stem}_wg_mma_kernel'
    return f'{stem}_mma_kernel' if exact else f'{stem}_mma_padded_kernel'


def mma_attributes(kernel: str, width: int, exact: bool = True) -> dict:
    """What the CUDA runtime reports for the 'mma' kernel ``'fwd'``,
    ``'dq'`` or ``'dkv'`` at the padded width ``width`` (one of
    :data:`WIDTHS`), the kernel a head of exactly ``width`` runs (its own
    build up to 64; above, every head of the width runs one kernel) or
    (``exact=False``) the one a narrower head runs, which takes the head
    size at run time; at a head over :data:`NARROW_MAX`, the kernel a head
    of that width runs (:func:`mma_kernel` names it): registers and local
    (spilled) bytes a thread, static shared memory, the dynamic shared
    memory its launcher sets, the blocks an SM and the blocks a cluster
    (``cluster_size``; 1 for a kernel launched without clusters), and for
    the paired kernels the clusters the card holds at once
    (``resident_clusters``, ``cudaOccupancyMaxActiveClusters``)."""
    if width <= NARROW_MAX and width not in WIDTHS:
        raise ValueError(f'flash attention: width {width} not in {WIDTHS} '
                         f'or over {NARROW_MAX}')
    out = (ctypes.c_int * 7)()
    lib = _build.load_library()
    number = MMA_KERNELS.index(kernel) + (
        2 * len(MMA_KERNELS) if width > NARROW_MAX
        else 0 if exact else len(MMA_KERNELS))
    _build.check(lib, lib.mv2_flash_mma_attributes(number, width, out),
                 f'flash attention {kernel} attributes')
    attrs = dict(zip(('registers', 'local_bytes', 'static_smem_bytes',
                      'dynamic_smem_bytes', 'blocks_per_sm', 'cluster_size',
                      'resident_clusters'), out))
    if attrs['cluster_size'] == 1:
        del attrs['resident_clusters']
    return attrs


def row_delta(dout, out):
    """D = rowsum(dO * O) in float32: elementwise, outside the kernels as in
    the JAX package."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def _launch_bwd(q, k, v, bias, out, lse, dout, causal: bool, scale: float,
                need_dbias: bool):
    _check_cuda('flash_attention_bwd', q, k, v, bias, out, lse, dout)
    dt = q.dtype
    q, k, v = _aligned(q), _aligned(k.to(dt)), _aligned(v.to(dt))
    dout = _aligned(dout.to(dt))
    bias_k = None if bias is None else _aligned(bias.to(dt))
    delta, lse = row_delta(dout, out), lse.contiguous()
    dq, ds = flash_backward_dq(q, k, v, bias_k, dout, lse, delta, causal, scale,
                            need_dbias)
    dk, dv = flash_backward_dkv(q, k, v, bias_k, dout, lse, delta, causal, scale)
    dbias = None if ds is None else _reduce_bias_groups(ds, bias)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """q, k, v ``(b, h, ., d)``, bias ``(groups, n, m)`` or None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        if q.is_cuda:
            out, lse = flash_forward(q, k, v, bias, causal, scale)
        else:
            out, lse = flash_attention_ref(q, k, v, causal, scale, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        if q.is_cuda:
            dq, dk, dv, dbias = _launch_bwd(
                q, k, v, bias, out, lse, dout, ctx.causal, ctx.scale,
                need_dbias)
        else:
            dq, dk, dv, dbias = flash_attention_bwd_ref(
                q, k, v, bias, out, lse, dout, ctx.causal, ctx.scale)
        return dq, dk, dv, dbias if need_dbias else None, None, None


def bias_groups(bias, b: int, h: int, n: int, m: int):
    """A bias ``(n, m)``, ``(h, n, m)`` or ``(b, h, n, m)`` as
    ``(groups, n, m)`` with groups in ``{1, h, b h}`` (views, so autograd
    carries the gradient back to the caller's shape)."""
    if bias.ndim == 2:
        bias = bias[None]
    elif bias.ndim == 4:
        if tuple(bias.shape[:2]) != (b, h):
            raise ValueError(f'bias {tuple(bias.shape)} does not fit '
                             f'b={b}, h={h}')
        bias = bias.reshape(b * h, n, m)
    if bias.ndim != 3 or tuple(bias.shape[-2:]) != (n, m):
        raise ValueError(f'bias {tuple(bias.shape)} does not fit n={n}, m={m}')
    if bias.shape[0] not in (1, h, b * h):
        raise ValueError(f'bias groups {bias.shape[0]} not in '
                         f'{(1, h, b * h)}')
    return bias


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None):
    """q ``(b, h, n, d)``; k, v ``(b, h, m, d)``, any ``m >= 1`` and
    ``d >= 1``; returns ``(b, h, n, d)``. ``bias``: optional additive
    pre-softmax bias ``(n, m)``, ``(h, n, m)`` or ``(b, h, n, m)``,
    differentiable. A head that is no multiple of 8 runs zero-padded to the
    next one (the scale from the true d) and is sliced back. The backward of
    a biased call on the card holds dS as ``(b h, n, m)`` float32 when the
    bias needs a gradient."""
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f'flash_attention: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    b, h, n, d = q.shape
    m = k.shape[-2]
    check_dim_head(d)
    if m < 1:
        raise ValueError('flash_attention: no keys')
    scale = d ** -0.5 if scale is None else scale
    if bias is not None:
        bias = bias_groups(bias, b, h, n, m)
    pad = -d % 8
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = _FlashAttention.apply(q, k, v, bias, bool(causal), float(scale))
    return out[..., :d] if pad else out
