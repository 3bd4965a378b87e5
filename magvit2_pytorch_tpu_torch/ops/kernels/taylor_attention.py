"""Second-order Taylor linear attention block.

Replaces the TPU kernel ``magvit2_pytorch_tpu/ops/pallas/taylor_attention.py``
``_taylor_kernel`` / ``_taylor_frame`` (``_taylor_fused``, :245; entry
``taylor_linear_attention``, :325). Per frame and head, with
phi(t) = [t, t (x) t / sqrt2] (d + d^2 features; the constant feature is
folded in as sum v and N):

    x -> RMSNorm(gamma) -> qkv (float32) -> q = (q * d^-1/2) cast, k, v cast
    [A | S] = phi(k)^T [v | 1]        float32 sums, then cast (A, S)
    num = phi(q) A + sum_n v,  den = phi(q) S + N      (float32)
    out = cast(num * cast(1 / (den + eps))) Wout

With ``gamma=None`` the block skips the norm: the input is normed already
(``apply_norm=False`` of the TPU kernel, :245-322, which the conditioned
``LinearAttention`` reaches after its ``AdaptiveRMSNorm``). That route
makes three launches, the qkv GEMM reading x itself.

The casts are ``_taylor_frame``'s (:74-107): in bf16 every phi entry rounds
twice (the product ``t_i t_j``, then ``* inv_sqrt2``, whose constant is the
bf16 0.70703125), A and S round after their float32 sums, sum v and N stay
float32, and ``1 / (den + eps)`` rounds before it scales num. In float32
every cast is the identity.

The CUDA version makes four launches on scratch the wrapper allocates
(:func:`taylor_launches`): the row RMSNorm and the qkv GEMM of
``csrc/gemm.cu`` (its epilogue scales q by d^-1/2 in float32 and casts q, k
and v once to the working dtype), the moment core of
``csrc/taylor_attention.cu``, and the out GEMM. The core has two routes,
picked by a static rule (:func:`taylor_core_route`) and counted apart:

- ``'mma'`` (bf16): tensor cores. A block of eight warps owns one frame and
  four heads; it streams the frame's k and v, then q, through a
  three-stage shared-memory ring in chunks of 128 tokens (64 bytes of each
  a token for the four heads, 16-byte ``cp.async``), builds phi(k) in bf16
  registers and accumulates [A | S] = phi(k)^T [v | 1] on ``mma.sync``
  m16n8k16 (80 feature rows: 72, the constant that gives sum v, padding).
  Two warps share a head, each over every other 16-token tile; their
  partials meet in shared memory in a fixed order (no atomics: a frame's
  output does not depend on its batch). Then A and S round to bf16, and
  per 16-token tile [num | den] = phi(q) [A | S] on the tensor cores,
  r = bf16(1 / (den + eps)), out = bf16(num r). Four heads a block keep
  the loads 64 bytes wide and give 640 blocks at the flagship (160 frames
  x 16 heads), ~2.4 waves of two blocks an SM; all 16 heads would give 160
  blocks (1.2 waves on 132 SMs) and 64 KB stages of k and v.
- ``'f32'`` (float32): one block per (frame, head) on the CUDA cores, each
  moment with one owner thread, then one thread per token.

What bounds it on the H100: at the flagship shape (160 frames x 1024 tokens
x 256 channels, 16 heads x 8, batch 8) the two projections hold most of the
FLOPs (the ``'wgmma'`` route of ``gemm.py``); the core alone is bound by
bytes (bf16 q, k, v in and the attention out, ~168 MB, 0.05 ms). Fusing
the out projection into the core's second phase is later work.

On the CPU the wrappers run the plain versions below, and autograd
differentiates them. On a CUDA tensor they launch the kernel or raise; the
backward recomputes through :func:`taylor_attention_twin`, the counterpart
of the JAX custom VJP's XLA twin. A head size the core does not take never
reaches it: :func:`taylor_eligible` sends it to the plain version on both
devices (``ops/attention.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.kernels import _build, gemm

# launches of the block and of each core route since the last reset (see
# ops/kernels); the block's GEMMs count in gemm.LAUNCHES
LAUNCHES = {'taylor_attention_block': 0,
            'taylor_attention_block_no_norm': 0, 'taylor_core_mma': 0,
            'taylor_core_f32': 0, 'taylor_attention_block_backward': 0}

SUPPORTED_DIM_HEAD = (8,)     # csrc/taylor_attention.cu: both cores
CORES = {'f32': 0, 'mma': 1}  # csrc/taylor_attention.cu TaylorRoute
INV_SQRT2 = 0.5 ** 0.5


def taylor_eligible(dim_head: int) -> bool:
    """Static gate of the Taylor block: a head size the CUDA cores take.
    It does not look at the device, so a module routes the same way on the
    CPU and the card; an ineligible module takes the plain version on both
    (the JAX package takes its XLA reference for the calls its kernel does
    not take, ``taylor_attention.py:337-361``)."""
    return dim_head in SUPPORTED_DIM_HEAD


def taylor_core_route(dtype, dim_head: int) -> str:
    """The moment core of a block call: ``'mma'`` (tensor cores) for bf16,
    ``'f32'`` (CUDA cores) for float32. No route gives way to another; a
    head size neither takes raises."""
    if dim_head not in SUPPORTED_DIM_HEAD:
        raise ValueError(f'taylor core: dim_head {dim_head} not in '
                         f'{SUPPORTED_DIM_HEAD}')
    if dtype == torch.bfloat16:
        return 'mma'
    if dtype == torch.float32:
        return 'f32'
    raise TypeError(f'taylor core: kernels take float32 or bfloat16, got '
                    f'{dtype}')


def taylor_core_ref(qkv, frames: int, heads: int, dim_head: int,
                    eps: float = 1e-5):
    """Plain version of :func:`taylor_core`: qkv ``(frames * N, 3 * heads *
    dim_head)`` in the working dtype, q already scaled by d^-1/2, to attn
    ``(frames * N, heads * dim_head)``, with ``_taylor_frame``'s casts."""
    dt = qkv.dtype
    n = qkv.shape[0] // frames
    hd = heads * dim_head
    q, k, v = (qkv[:, i * hd:(i + 1) * hd].reshape(frames, n, heads,
                                                   dim_head)
               for i in range(3))
    inv_sqrt2 = torch.tensor(INV_SQRT2, dtype=dt,
                             device=qkv.device)    # bf16: 0.70703125

    def phi(t):     # each product rounds, then the product with inv_sqrt2
        outer = t[..., :, None] * t[..., None, :] * inv_sqrt2
        return torch.cat([t, outer.flatten(-2)], dim=-1).float()

    pq, pk = phi(q), phi(k)
    v32 = v.float()
    a = torch.einsum('gnhf,gnhe->ghfe', pk, v32).to(dt).float()
    s = pk.sum(dim=1).to(dt).float()                      # (g, h, f)
    num = torch.einsum('gnhf,ghfe->gnhe', pq, a) + v32.sum(dim=1)[:, None]
    den = torch.einsum('gnhf,ghf->gnh', pq, s) + n
    r = (1.0 / (den + eps)).to(dt).float()
    return (num * r[..., None]).to(dt).reshape(frames * n, hd)


def taylor_attention_ref(x, gamma, wqkv, wout, heads: int, dim_head: int,
                         eps: float = 1e-5):
    """Plain version on ``(B, N, C)``. gamma ``(C,)``, or None for the
    no-norm route; wqkv ``(3 * heads * dim_head, C)`` in (qkv, head, d) row
    order, wout ``(C, heads * dim_head)``."""
    dt = x.dtype
    b, n, c = x.shape
    hd = heads * dim_head
    xn = x.reshape(b * n, c)
    if gamma is not None:
        xn = gemm.rmsnorm_ref(xn, gamma)
    qkv = gemm.gemm_nt_ref(xn, wqkv.to(dt), scaled_cols=hd,
                           col_scale=dim_head ** -0.5)
    attn = taylor_core_ref(qkv, b, heads, dim_head, eps)
    return gemm.gemm_nt_ref(attn, wout.to(dt)).reshape(b, n, c)


def taylor_core(qkv, frames: int, heads: int, dim_head: int,
                eps: float = 1e-5):
    """The moment core of a block (see :func:`taylor_core_ref`); on the card
    on the route :func:`taylor_core_route` picks."""
    if not qkv.is_cuda:
        return taylor_core_ref(qkv, frames, heads, dim_head, eps)
    route = taylor_core_route(qkv.dtype, dim_head)
    rows, cols = qkv.shape
    hd = heads * dim_head
    if cols != 3 * hd or rows % frames or not qkv.is_contiguous():
        raise ValueError(f'taylor core: qkv {tuple(qkv.shape)} is not '
                         f'{frames} frames of contiguous rows of {3 * hd}')
    attn = torch.empty((rows, hd), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load_library()
    code = lib.mv2_taylor_core(
        qkv.data_ptr(), attn.data_ptr(), _build.dtype_code(qkv), frames,
        rows // frames, heads, dim_head, float(eps), CORES[route],
        _build.stream_handle(qkv.device))
    _build.check(lib, code, f'taylor core ({route})')
    LAUNCHES[f'taylor_core_{route}'] += 1
    return attn


def taylor_launches(x, gamma, wqkv, wout, heads: int, dim_head: int,
                    eps: float = 1e-5):
    """The four launches of the block on ``(B, N, C)``: RMSNorm (none when
    ``gamma`` is None), the qkv GEMM (q scaled in its epilogue), the core,
    the out GEMM. On CPU tensors each takes its plain version, so the
    composition is testable there."""
    dt = x.dtype
    b, n, c = x.shape
    hd = heads * dim_head
    xn = x.reshape(b * n, c)
    if gamma is not None:
        xn = gemm.rmsnorm(xn, gamma)
    qkv = gemm.gemm_nt(xn, wqkv.to(dt), scaled_cols=hd,
                       col_scale=dim_head ** -0.5)
    attn = taylor_core(qkv, b, heads, dim_head, eps)
    return gemm.gemm_nt(attn, wout.to(dt)).reshape(b, n, c)


def taylor_attention_twin(x, gamma, wqkv, wout, heads: int, dim_head: int,
                          eps: float = 1e-5):
    """What the block's backward differentiates on the card: the port's
    counterpart of ``_taylor_reference`` (``taylor_attention.py:173-205``),
    the twin the JAX custom VJP recomputes through, with its cast points:
    qkv in the working dtype, ``q * d^-1/2`` rounded, phi = [1, t, t (x) t /
    sqrt2] in the working dtype (both constants rounded to it first, as a
    Python scalar is in JAX), the moments summed in float32 and rounded
    before the products with phi(q), ``num / (den + eps)`` rounded once.
    ``gamma`` None: no norm (``apply_norm=False``)."""
    dt = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    if gamma is not None:
        x = gemm.rmsnorm_ref(x, gamma)
    qkv = F.linear(x, wqkv.to(dt)).reshape(b, n, 3, heads, dim_head)
    scale, inv_sqrt2 = torch.tensor([dim_head ** -0.5, INV_SQRT2],
                                    dtype=dt).tolist()
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1], qkv[:, :, 2]

    def phi(t):
        outer = t[..., :, None] * t[..., None, :] * inv_sqrt2
        return torch.cat([torch.ones_like(t[..., :1]), t,
                          outer.flatten(-2)], dim=-1).float()

    pq, pk = phi(q), phi(k)
    kv = torch.einsum('bnhf,bnhe->bhfe', pk, v.float()).to(dt).float()
    num = torch.einsum('bnhf,bhfe->bnhe', pq, kv)
    den = torch.einsum('bnhf,bhf->bnh', pq, pk.sum(dim=1).to(dt).float())
    out = (num / (den[..., None] + eps)).to(dt).reshape(b, n, hd)
    return F.linear(out, wout.to(dt))


def _block_launch(x, gamma, wqkv, wout, heads, dim_head, eps):
    name = 'taylor_attention_block'
    _build.check_cuda_inputs(
        name, x, tuple(t for t in (gamma, wqkv, wout) if t is not None))
    if not taylor_eligible(dim_head):
        raise ValueError(f'{name}: dim_head {dim_head} not in '
                         f'{SUPPORTED_DIM_HEAD}')
    c = x.shape[-1]
    hd = heads * dim_head
    if wqkv.shape != (3 * hd, c) or wout.shape != (c, hd):
        raise ValueError(f'{name}: wqkv {tuple(wqkv.shape)} / wout '
                         f'{tuple(wout.shape)} do not fit C={c}, '
                         f'heads*dim_head={hd}')
    out = taylor_launches(x, gamma, wqkv, wout, heads, dim_head, eps)
    LAUNCHES[name] += 1
    if gamma is None:
        LAUNCHES['taylor_attention_block_no_norm'] += 1
    return out


class _TaylorBlock(torch.autograd.Function):
    """The block on the card: the forward launches the kernels; the backward
    recomputes through :func:`taylor_attention_twin` and differentiates it,
    as the JAX custom VJP does (``taylor_attention.py:304-319``). Without a
    norm there is no gamma, so no dgamma (the JAX ``_bwd`` returns zeros
    for the ones it passes in its place)."""

    @staticmethod
    def forward(ctx, x, gamma, wqkv, wout, heads, dim_head, eps):
        ctx.save_for_backward(x, gamma, wqkv, wout)
        ctx.args = (heads, dim_head, eps)
        return _block_launch(x, gamma, wqkv, wout, heads, dim_head, eps)

    @staticmethod
    def backward(ctx, grad):
        LAUNCHES['taylor_attention_block_backward'] += 1
        grads = _build.recompute_grads(
            lambda *a: taylor_attention_twin(*a, *ctx.args),
            ctx.saved_tensors, ctx.needs_input_grad[:4], grad)
        return (*grads, None, None, None)


def taylor_attention(x, gamma, wqkv, wout, heads: int, dim_head: int,
                     eps: float = 1e-5):
    """Taylor attention block on ``(B, N, C)`` (see ``taylor_attention_ref``);
    differentiable on both devices."""
    if not x.is_cuda:
        return taylor_attention_ref(x, gamma, wqkv, wout, heads, dim_head,
                                    eps)
    return _TaylorBlock.apply(x, gamma, wqkv, wout, heads, dim_head, eps)
