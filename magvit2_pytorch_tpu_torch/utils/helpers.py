"""Small option/tensor helpers (PyTorch counterpart of
``magvit2_pytorch_tpu/utils/helpers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def exists(v):
    return v is not None


def default(v, d):
    return v if exists(v) else d


def cast_tuple(t, length: int = 1):
    return t if isinstance(t, tuple) else ((t,) * length)


def divisible_by(num, den) -> bool:
    return (num % den) == 0


def safe_get_index(it, ind, default=None):
    if ind < len(it):
        return it[ind]
    return default


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``t / max(||t||, eps)`` along ``dim`` (``F.normalize`` semantics)."""
    return F.normalize(t, p=2, dim=dim, eps=eps)

