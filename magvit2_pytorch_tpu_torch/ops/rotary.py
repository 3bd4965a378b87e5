"""Axial rotary position embeddings for the tokenizer's attention (PyTorch
counterpart of ``magvit2_pytorch_tpu/ops/rotary.py``).

- time attention: 1D RoPE over frame positions;
- space attention: axial 2D RoPE: the first half of each head's dim pairs
  rotates with the row index, the second half with the column index.

The learned memory key/values stay unrotated (they carry no position).
Angles are float32; the rotation runs in float32 and casts back.
"""

from __future__ import annotations

import torch


def rope_angles(positions, dim: int, base: float = 10000.0):
    """positions ``(n,)`` int or float -> ``(cos, sin)``, each
    ``(n, dim // 2)`` float32 on the positions' device."""
    assert dim % 2 == 0
    half = dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32,
                                      device=positions.device), exponent)
    angles = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def rope_angles_2d(h: int, w: int, dim: int, base: float = 10000.0,
                   device=None):
    """Axial 2D angles for a flattened row-major ``h * w`` sequence: the
    first ``dim // 4`` pairs rotate with the row index, the rest with the
    column index. Returns ``(cos, sin)``, each ``(h * w, dim // 2)``."""
    assert dim % 4 == 0
    quarter = dim // 4
    rows = torch.arange(h, dtype=torch.float32,
                        device=device).repeat_interleave(w)
    cols = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    cos_r, sin_r = rope_angles(rows, 2 * quarter, base)
    cos_c, sin_c = rope_angles(cols, 2 * quarter, base)
    return (torch.cat([cos_r, cos_c], dim=-1),
            torch.cat([sin_r, sin_c], dim=-1))


def apply_rope(t, cos, sin):
    """Rotate consecutive pairs of the head dim. t ``(b, n, heads, d)``;
    cos, sin ``(n, d // 2)``. Norm-preserving; float32 math, cast back to
    ``t.dtype``."""
    b, n, heads, d = t.shape
    t32 = t.to(torch.float32).reshape(b, n, heads, d // 2, 2)
    t_even, t_odd = t32[..., 0], t32[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([t_even * c - t_odd * s, t_even * s + t_odd * c],
                      dim=-1)
    return out.reshape(b, n, heads, d).to(t.dtype)
