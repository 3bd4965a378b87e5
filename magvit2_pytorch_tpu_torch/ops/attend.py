"""Attention with learned memory key/values (PyTorch counterpart of
``magvit2_pytorch_tpu/ops/attend.py:attend_with_memory``)."""

from __future__ import annotations

from typing import Optional

import torch

from magvit2_pytorch_tpu_torch.utils.helpers import default


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
        i = torch.arange(n, device=q.device)[:, None]
        j = torch.arange(m_seq, device=q.device)[None, :]
        dots = dots.masked_fill(j > i + (m_seq - n),
                                torch.finfo(torch.float32).min)

    mx = torch.maximum(dots.amax(dim=-1), dots_mem.amax(dim=-1))
    e_seq = torch.exp(dots - mx[..., None])
    e_mem = torch.exp(dots_mem - mx[..., None])
    den = e_seq.sum(dim=-1) + e_mem.sum(dim=-1)                 # (b, h, i)

    out = (torch.einsum('bhij,bjhd->bihd', e_seq.to(v.dtype), v)
           + torch.einsum('bhim,hmd->bihd', e_mem.to(v.dtype), mem_v))
    out = out / den.transpose(1, 2)[..., None]
    return out.to(q.dtype)
