"""Attention core: backend-dispatched scaled-dot-product attention (PyTorch
counterpart of ``magvit2_pytorch_tpu/ops/attend.py``).

Two backends behind one interface:

- ``'plain'`` (alias ``'xla'``, the name a setting carried over from the JAX
  package has): einsum + float32 softmax in PyTorch.
- ``'flash'``: the hand-written CUDA flash-attention kernels
  (``ops/kernels/flash_attention.py``), forward and backward. On CPU tensors
  that wrapper runs its plain version.
- ``'auto'`` (the default): flash on a CUDA tensor when there is no mask,
  bias or ``prev_attn`` and the shapes are flash-friendly, else plain.

Semantics kept from the reference's ``Attend``:
- right-aligned causal mask when ``k_len > q_len`` (memory-KV tokens are
  visible to every query);
- causal disabled for single-query decode;
- a fully masked row returns zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from magvit2_pytorch_tpu_torch.utils.helpers import default, exists

BACKENDS = ('auto', 'plain', 'xla', 'flash')
_DEFAULT_BACKEND = 'auto'


def set_default_attend_backend(backend: str):
    assert backend in BACKENDS
    global _DEFAULT_BACKEND
    _DEFAULT_BACKEND = backend


def get_default_attend_backend() -> str:
    return _DEFAULT_BACKEND


def causal_hidden(n: int, m: int, device):
    """(n, m) bool, True where the right-aligned causal mask hides key j from
    query i: ``j > i + (m - n)``. The ``m - n`` extra keys on the left (the
    memory KV) are visible to every query."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(m, device=device)[None, :]
    return j > i + (m - n)


def _flash_friendly_nm(n: int, m: int, d: int) -> bool:
    """Where ``'auto'`` picks flash: the JAX package's rule, head size 32 to
    256 and at least 1024 queries and keys (the kernels take every such
    call). ``chip_smoke.py`` times flash against plain on both sides of the
    threshold; PERF.md records what the card says about it."""
    return 32 <= d <= 256 and n >= 1024 and m >= 1024


def attend(
    q, k, v,
    causal: bool = False,
    mask=None,
    scale: Optional[float] = None,
    backend: Optional[str] = None,
    layout: str = 'bhnd',
    attn_bias=None,
    prev_attn=None,
):
    """Scaled-dot-product attention.

    ``layout='bhnd'``: q ``(b, h, n, d)``; k, v ``(b, h, m, d)``.
    ``layout='bnhd'``: q ``(b, n, h, d)``; k, v ``(b, m, h, d)``, the
    projection layout.
    mask: ``(b, h, n, m)`` bool (True = keep). The softmax runs in float32.
    attn_bias: additive pre-softmax bias, ``(h, n, m)`` or ``(b, h, n, m)``.
    prev_attn: residual pre-softmax logits ``(b, h, n, m)``, added before the
    bias; not compatible with flash.
    """
    assert layout in ('bhnd', 'bnhd')
    backend = default(backend, _DEFAULT_BACKEND)
    assert backend in BACKENDS, backend
    if backend == 'xla':
        backend = 'plain'
    seq_axis = -2 if layout == 'bhnd' else -3
    n, m = q.shape[seq_axis], k.shape[seq_axis]

    if n == 1 and causal:
        causal = False

    if backend == 'auto':
        backend = 'flash' if (
            q.is_cuda and _flash_friendly_nm(n, m, q.shape[-1])
            and not exists(mask) and not exists(attn_bias)
            and not exists(prev_attn)) else 'plain'
    assert not (backend == 'flash' and exists(prev_attn)), (
        'residual attention not compatible with flash attention')
    if exists(prev_attn):
        backend = 'plain'

    if backend == 'flash' and not exists(mask):
        # the kernel carries an additive bias (differentiable, broadcast
        # aware); 'auto' still sends biased attention to the plain backend
        from magvit2_pytorch_tpu_torch.ops.kernels.flash_attention import (
            flash_attention)
        if layout == 'bnhd':
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              bias=attn_bias)
        return out.transpose(1, 2) if layout == 'bnhd' else out

    return _attend_plain(q, k, v, causal=causal, mask=mask, scale=scale,
                         attn_bias=attn_bias, prev_attn=prev_attn,
                         layout=layout)


def _attend_plain(q, k, v, causal, mask, scale, attn_bias=None,
                  prev_attn=None, layout: str = 'bhnd'):
    """Both layouts of the JAX package's ``_attend_xla`` /
    ``_attend_xla_bnhd``: with ``'bnhd'`` the head axis rides along as an
    einsum batch dim, no transposes."""
    bhnd = layout == 'bhnd'
    d = q.shape[-1]
    n, m = (q.shape[-2], k.shape[-2]) if bhnd else (q.shape[1], k.shape[1])
    scale = default(scale, d ** -0.5)

    dots = torch.einsum('bhid,bhjd->bhij' if bhnd else 'bihd,bjhd->bhij',
                        q.float(), k.float()) * scale
    # the reference's order: prev_attn first, then the bias
    if exists(prev_attn):
        dots = dots + prev_attn.to(dots.dtype)
    if exists(attn_bias):
        if attn_bias.ndim == 3:
            attn_bias = attn_bias[None]
        dots = dots + attn_bias.to(dots.dtype)

    mask_value = torch.finfo(torch.float32).min

    if causal:
        dots = dots.masked_fill(causal_hidden(n, m, q.device), mask_value)

    row_all_masked = None
    if exists(mask):
        dots = dots.masked_fill(~mask, mask_value)
        row_all_masked = ~mask.any(dim=-1)                      # (b, h, n)

    attn = torch.softmax(dots, dim=-1)
    out = torch.einsum('bhij,bhjd->bhid' if bhnd else 'bhij,bjhd->bihd',
                       attn.to(v.dtype), v)

    if exists(row_all_masked):
        if not bhnd:
            row_all_masked = row_all_masked.transpose(1, 2)
        out = out.masked_fill(row_all_masked[..., None], 0.0)

    return out.to(q.dtype)


def attend_with_memory(q, k, v, mem_k, mem_v, causal: bool = False,
                       scale: Optional[float] = None):
    """q, k, v: ``(b, n, h, d)``; mem_k, mem_v: ``(h, m, d)``. One softmax over
    the sequence and memory logits together, in float32. Memory keys are
    visible to every query; the causal mask is right-aligned (query i sees
    keys j <= i + (len(k) - n); reference attend.py:109-129)."""
    d = q.shape[-1]
    n, m_seq = q.shape[1], k.shape[1]
    scale = default(scale, d ** -0.5)

    q32 = q.float()
    dots = torch.einsum('bihd,bjhd->bhij', q32, k.float()) * scale
    dots_mem = torch.einsum('bihd,hmd->bhim', q32, mem_k.float()) * scale

    if causal and n > 1:
        dots = dots.masked_fill(causal_hidden(n, m_seq, q.device),
                                torch.finfo(torch.float32).min)

    mx = torch.maximum(dots.amax(dim=-1), dots_mem.amax(dim=-1))
    e_seq = torch.exp(dots - mx[..., None])
    e_mem = torch.exp(dots_mem - mx[..., None])
    den = e_seq.sum(dim=-1) + e_mem.sum(dim=-1)                 # (b, h, i)

    out = (torch.einsum('bhij,bjhd->bihd', e_seq.to(v.dtype), v)
           + torch.einsum('bhim,hmd->bihd', e_mem.to(v.dtype), mem_v))
    out = out / den.transpose(1, 2)[..., None]
    return out.to(q.dtype)
