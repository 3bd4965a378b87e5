"""Evaluation metrics (PyTorch counterpart of
``magvit2_pytorch_tpu/training/metrics.py``): reconstruction PSNR, codebook
utilization and per-batch code entropy."""

from __future__ import annotations


import torch


def psnr(a, b, max_val: float = 1.0):
    """Peak signal-to-noise ratio between two [0, max_val] videos/images."""
    return psnr_from_mse(((a.float() - b.float()) ** 2).mean(), max_val)


def psnr_from_mse(mse, max_val: float = 1.0):
    """PSNR of a mean squared error (of a batch split over ranks, the mean
    of their errors)."""
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def _counts(indices, codebook_size: int):
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=codebook_size)


def codes_hit(indices, codebook_size: int):
    """A mask of the codes hit at least once in ``indices``."""
    return _counts(indices, codebook_size) > 0


def codebook_utilization(indices, codebook_size: int):
    """Fraction of the codebook hit at least once in ``indices``."""
    return codes_hit(indices, codebook_size).float().mean()


def code_entropy(indices, codebook_size: int):
    """Empirical entropy (nats) of the code distribution in the batch; at
    most ``log(codebook_size)``."""
    counts = _counts(indices, codebook_size).float()
    p = counts / max(indices.numel(), 1)
    return -torch.where(p > 0, p * torch.log(p.clamp_min(1e-12)),
                        torch.zeros_like(p)).sum()


__all__ = ['psnr', 'psnr_from_mse', 'codes_hit', 'codebook_utilization',
           'code_entropy']
