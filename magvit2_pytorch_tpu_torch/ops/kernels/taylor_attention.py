"""Second-order Taylor linear attention block.

Replaces the TPU kernel ``magvit2_pytorch_tpu/ops/pallas/taylor_attention.py``
``_taylor_kernel`` / ``_taylor_frame`` (``_taylor_fused``, :245; entry
``taylor_linear_attention``, :325). It computes, per frame and head,

    x -> RMSNorm(gamma) -> qkv (float32) -> q = (q * d^-1/2) cast, k, v cast
    A0 = sum_n v,  A1 = k^T v,  A2 = (k (x) k / sqrt2)^T v       (float32)
    num = A0 + q A1 + (q (x) q / sqrt2) A2
    den = N + q . sum_n k + (q (x) q / sqrt2) . sum_n (k (x) k / sqrt2)
    out = (num / (den + eps)) Wout

so phi(x) = [1, x, x (x) x / sqrt2] is never materialised.

The CUDA version makes four launches on scratch the wrapper allocates: the
row RMSNorm and the qkv GEMM into float32 of ``csrc/gemm.cu``, the moment
core of ``csrc/taylor_attention.cu`` (one block per (frame, head) that
reduces the moments over the N tokens in shared memory and then writes each
token's output), and the out GEMM.

What bounds it on the H100: at the flagship shape (160 frames x 1024 tokens
x 256 channels, 16 heads x 8, batch 8) the two projections hold most of the
FLOPs (bf16: the ``'wgmma'`` route of ``gemm.py``; float32: CUDA cores), and
the float32 qkv scratch (3 x 128 values a token) is the largest memory
traffic.
The moment reduction is ~d^3 FMAs a token per head, done in shared memory
with one owner thread per moment, so no atomics are needed. Keeping qkv out
of device memory and fusing the launches are later work.

On the CPU the wrapper runs the plain version below. On a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.kernels import _build, gemm

LAUNCHES = {'taylor_attention_block': 0}

SUPPORTED_DIM_HEAD = (8,)     # csrc/taylor_attention.cu template cases
INV_SQRT2 = 0.5 ** 0.5


def taylor_attention_ref(x, gamma, wqkv, wout, heads: int, dim_head: int,
                         eps: float = 1e-5):
    """Plain version on ``(B, N, C)``. gamma ``(C,)``, wqkv
    ``(3 * heads * dim_head, C)`` in (qkv, head, d) row order, wout
    ``(C, heads * dim_head)``."""
    dt = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    x = gemm.rmsnorm_ref(x, gamma)
    qkv = F.linear(x.float(), wqkv.to(dt).float())     # float32 accumulate
    q = (qkv[..., :hd] * dim_head ** -0.5).to(dt).float()
    k = qkv[..., hd:2 * hd].to(dt).float()
    v = qkv[..., 2 * hd:].to(dt).float()
    q, k, v = (t.reshape(b, n, heads, dim_head) for t in (q, k, v))

    kk = torch.einsum('bnhi,bnhj->bnhij', k, k) * INV_SQRT2
    qq = torch.einsum('bnhi,bnhj->bnhij', q, q) * INV_SQRT2
    a0 = v.sum(dim=1)                                        # (b, h, e)
    a1 = torch.einsum('bnhi,bnhe->bhie', k, v)
    a2 = torch.einsum('bnhij,bnhe->bhije', kk, v)
    num = (a0[:, None] + torch.einsum('bnhi,bhie->bnhe', q, a1)
           + torch.einsum('bnhij,bhije->bnhe', qq, a2))
    den = (n + torch.einsum('bnhi,bhi->bnh', q, k.sum(dim=1))
           + torch.einsum('bnhij,bhij->bnh', qq, kk.sum(dim=1)))
    acc = (num * (1.0 / (den + eps))[..., None]).to(dt).reshape(b, n, hd)
    return F.linear(acc.float(), wout.to(dt).float()).to(dt)


def taylor_attention(x, gamma, wqkv, wout, heads: int, dim_head: int,
                     eps: float = 1e-5):
    """Taylor attention block on ``(B, N, C)`` (see ``taylor_attention_ref``)."""
    if not x.is_cuda:
        return taylor_attention_ref(x, gamma, wqkv, wout, heads, dim_head,
                                    eps)
    name = 'taylor_attention_block'
    _build.check_cuda_inputs(name, x, (gamma, wqkv, wout))
    if dim_head not in SUPPORTED_DIM_HEAD:
        raise ValueError(f'{name}: dim_head {dim_head} not in '
                         f'{SUPPORTED_DIM_HEAD}')
    dt = x.dtype
    b, n, c = x.shape
    hd = heads * dim_head
    if wqkv.shape != (3 * hd, c) or wout.shape != (c, hd):
        raise ValueError(f'{name}: wqkv {tuple(wqkv.shape)} / wout '
                         f'{tuple(wout.shape)} do not fit C={c}, '
                         f'heads*dim_head={hd}')
    xn = gemm.rmsnorm(x.reshape(b * n, c), gamma)
    qkv = gemm.gemm_nt(xn, wqkv.to(dt), out_dtype=torch.float32)
    attn = torch.empty((b * n, hd), dtype=dt, device=x.device)
    lib = _build.load_library()
    code = lib.mv2_taylor_core(
        qkv.data_ptr(), attn.data_ptr(), _build.dtype_code(x), b, n, heads,
        dim_head, float(eps), _build.stream_handle(x.device))
    _build.check(lib, code, name)
    out = gemm.gemm_nt(attn, wout.to(dt))
    LAUNCHES[name] += 1
    return out.reshape(b, n, c)
