"""Lookup-free quantization, eval path (PyTorch counterpart of
``magvit2_pytorch_tpu/ops/quantizers.py:LFQ``).

``project_in`` to ``log2(codebook_size)`` dims, soft clamp
``tanh(z / v) * v``, codes ``+-1`` by sign, indices the MSB-first bit string
of ``z > 0``, ``project_out`` back. The quantization math runs in float32.
Training losses, spherical codes, several codebooks and FSQ are not ported
yet (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import Linear
from magvit2_pytorch_tpu_torch.utils.helpers import exists


class QuantizerOutput(NamedTuple):
    quantized: torch.Tensor
    indices: torch.Tensor
    aux_loss: torch.Tensor


class LFQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int,
                 soft_clamp_input_value: Optional[float] = 10.0):
        super().__init__()
        codebook_dim = int(math.log2(codebook_size))
        assert 2 ** codebook_dim == codebook_size, (
            'codebook_size must be a power of 2')
        self.dim, self.codebook_dim = dim, codebook_dim
        self.soft_clamp_input_value = soft_clamp_input_value
        self.has_projections = dim != codebook_dim
        if self.has_projections:
            self.project_in = Linear(dim, codebook_dim)
            self.project_out = Linear(codebook_dim, dim)

    def _bit_mask(self, device):
        return 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=device)

    def sign_values(self, x):
        """The values whose signs are the code bits, float32 ``(..., d)``;
        ``|z|`` is each bit's decision margin."""
        if self.has_projections:
            x = self.project_in(x)
        z = x.float()
        if exists(self.soft_clamp_input_value):
            v = self.soft_clamp_input_value
            z = torch.tanh(z / v) * v
        return z

    def forward(self, x, train: bool = False) -> QuantizerOutput:
        """x ``(b, *spatial, dim)``. Returns the quantized tensor in x's dtype,
        int64 indices ``(b, *spatial)`` and a zero aux loss."""
        if train:
            raise NotImplementedError(
                'LFQ train=True (entropy and commitment losses) is training '
                'work: ROADMAP.md queue A item 6')
        z = self.sign_values(x)
        positive = z > 0
        codes = torch.where(positive, 1.0, -1.0)
        indices = (positive.long() * self._bit_mask(x.device)).sum(dim=-1)
        out = codes.to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        return QuantizerOutput(out, indices, torch.zeros((), device=x.device))

    def indices_to_codes(self, indices, dtype=torch.float32):
        """Inverse of the bit pack: indices ``(b, *spatial)`` -> +-1 codes ->
        ``project_out``, in ``dtype``."""
        bits = (indices[..., None] & self._bit_mask(indices.device)) != 0
        codes = torch.where(bits, 1.0, -1.0).to(dtype)
        if self.has_projections:
            codes = self.project_out(codes)
        return codes
