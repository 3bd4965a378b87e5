"""Lookup-free (LFQ) and finite scalar (FSQ) quantization (PyTorch
counterpart of ``magvit2_pytorch_tpu/ops/quantizers.py``).

LFQ: ``project_in`` to ``num_codebooks * log2(codebook_size)`` dims,
optional unit normalisation (``spherical``), soft clamp
``tanh(z / v) * v``, codes ``+-1`` (``+-1/sqrt(d)`` when spherical) by sign,
indices the MSB-first bit string of ``z > 0`` per codebook, ``project_out``
back. ``train=True`` adds the straight-through estimator and the aux losses
(per-sample entropy, codebook entropy with the diversity weight, and
commitment) with their ``LossBreakdown``: exact over the full codebook up to
``entropy_full_max_size`` codes, above it the factorized per-bit form, and
with ``exact_codebook_entropy`` the exact codebook entropy enumerated in
chunks.

FSQ: ``project_in`` where ``dim`` differs from the codebook dims, the
``tanh`` bound with its half-level offset, round (straight-through), scale to
``[-1, 1]``; indices in the mixed radix of the levels.

The quantization math runs in float32 whatever the working dtype; indices are
int64.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from magvit2_pytorch_tpu_torch.ops.basic import Linear
from magvit2_pytorch_tpu_torch.parallel.batch import global_row_mean
from magvit2_pytorch_tpu_torch.utils.helpers import default, exists, l2norm


class LossBreakdown(NamedTuple):
    per_sample_entropy: torch.Tensor
    codebook_entropy: torch.Tensor
    commitment: torch.Tensor


class QuantizerOutput(NamedTuple):
    quantized: torch.Tensor
    indices: torch.Tensor
    aux_loss: torch.Tensor
    breakdown: Optional[LossBreakdown] = None


def _bit_mask(bits: int, device):
    """MSB first: bit j of a code weighs ``2 ** (bits - 1 - j)``."""
    return 2 ** torch.arange(bits - 1, -1, -1, device=device)


def _binary_entropy(p):
    p = p.clamp(1e-7, 1 - 1e-7)
    return -(p * torch.log(p) + (1 - p) * torch.log(1 - p))


class LFQ(nn.Module):
    """The JAX package's ``LFQ``, field for field (defaults are the
    reference's, magvit2_pytorch.py:1364-1373)."""

    def __init__(self, dim: int, codebook_size: int, num_codebooks: int = 1,
                 entropy_loss_weight: float = 0.1,
                 commitment_loss_weight: float = 1.0,
                 diversity_gamma: float = 2.5,
                 soft_clamp_input_value: Optional[float] = 10.0,
                 spherical: bool = False, inv_temperature: float = 100.0,
                 keep_num_codebooks_dim: Optional[bool] = None,
                 entropy_full_max_size: int = 4096,
                 exact_codebook_entropy: bool = False,
                 entropy_chunk_size: int = 4096):
        super().__init__()
        codebook_dim = int(math.log2(codebook_size))
        assert 2 ** codebook_dim == codebook_size, (
            'codebook_size must be a power of 2')
        self.dim, self.codebook_size = dim, codebook_size
        self.codebook_dim, self.num_codebooks = codebook_dim, num_codebooks
        self.codebook_dims = codebook_dim * num_codebooks
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.diversity_gamma = diversity_gamma
        self.soft_clamp_input_value = soft_clamp_input_value
        self.spherical = spherical
        self.inv_temperature = inv_temperature
        self.keep_cb_dim = default(keep_num_codebooks_dim, num_codebooks > 1)
        self.entropy_full_max_size = entropy_full_max_size
        self.exact_codebook_entropy = exact_codebook_entropy
        self.entropy_chunk_size = entropy_chunk_size
        self.has_projections = dim != self.codebook_dims
        if self.has_projections:
            self.project_in = Linear(dim, self.codebook_dims)
            self.project_out = Linear(self.codebook_dims, dim)

    @property
    def code_scale(self) -> float:
        """The size of a code entry: 1, or ``1/sqrt(d)`` when spherical."""
        return self.codebook_dim ** -0.5 if self.spherical else 1.0

    def sign_values(self, x):
        """The values whose signs are the code bits, float32
        ``(..., num_codebooks, d)``; ``|z|`` is each bit's decision
        margin."""
        if self.has_projections:
            x = self.project_in(x)
        z = x.float().unflatten(-1, (self.num_codebooks, self.codebook_dim))
        if self.spherical:
            z = l2norm(z)
        if exists(self.soft_clamp_input_value):
            v = self.soft_clamp_input_value
            z = torch.tanh(z / v) * v
        return z

    def forward(self, x, train: bool = False) -> QuantizerOutput:
        """x ``(b, *spatial, dim)``. Returns the quantized tensor in x's
        dtype, int64 indices ``(b, *spatial[, num_codebooks])`` and the
        weighted aux loss with its breakdown (zeros unless ``train``)."""
        z = self.sign_values(x)
        positive = z > 0
        codes = torch.where(positive, 1.0, -1.0) * self.code_scale
        # eval returns the code values exactly; z + (codes - z) may differ
        # from them by an ulp
        quantized = z + (codes - z).detach() if train else codes
        indices = (positive.long()
                   * _bit_mask(self.codebook_dim, x.device)).sum(dim=-1)
        if train:
            per_sample, codebook = self._entropy_losses(
                z.flatten(0, -3))
            commitment = ((z - codes.detach()) ** 2).mean()
            aux = ((per_sample - self.diversity_gamma * codebook)
                   * self.entropy_loss_weight
                   + commitment * self.commitment_loss_weight)
            breakdown = LossBreakdown(per_sample, codebook, commitment)
        else:
            zero = torch.zeros((), device=x.device)
            aux, breakdown = zero, LossBreakdown(zero, zero, zero)
        out = quantized.flatten(-2).to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        if not self.keep_cb_dim:
            indices = indices.squeeze(-1)
        return QuantizerOutput(out, indices, aux, breakdown)

    def full_codebook(self, device=None):
        """All ``2 ** d`` sign patterns, row k the bits of k MSB first."""
        ks = torch.arange(self.codebook_size, device=device)
        bits = (ks[:, None] & _bit_mask(self.codebook_dim, device)) != 0
        return torch.where(bits, 1.0, -1.0)

    def _entropy_losses(self, z):
        """z ``(N, c, d)`` float32 -> (per-sample entropy, codebook entropy),
        as ``LFQ._entropy_losses`` of the JAX package."""
        t = self.inv_temperature
        if self.codebook_size <= self.entropy_full_max_size:
            codebook = self.full_codebook(z.device) * self.code_scale
            logits = 2.0 * t * torch.einsum('ncd,kd->nck', z, codebook)
            logp = torch.log_softmax(logits, dim=-1)
            p = logp.exp()
            per_sample = -(p * logp).sum(-1).mean()
            mean_p = global_row_mean(p)                                  # (c, K)
            codebook_ent = -(mean_p * torch.log(mean_p.clamp(min=1e-10))
                             ).sum(-1).mean()
            return per_sample, codebook_ent
        p_pos = torch.sigmoid(4.0 * t * self.code_scale * z)
        per_sample = _binary_entropy(p_pos).sum(-1).mean()
        if self.exact_codebook_entropy:
            return per_sample, self._chunked_codebook_entropy(z)
        codebook_ent = _binary_entropy(global_row_mean(p_pos)).sum(-1).mean()
        return per_sample, codebook_ent

    def _chunked_codebook_entropy(self, z):
        """The exact codebook entropy ``H(mean_n p(.|z_n))`` enumerated in
        chunks of ``entropy_chunk_size`` codes. p factorizes over bits, so a
        chunk's log-probabilities are one product with its bits. Each chunk
        runs under ``torch.utils.checkpoint``: the backward keeps the
        chunk's inputs, never its ``(N, c, chunk)`` intermediates, so memory
        stays O(chunk).

        A code's log-probability is its bits' log-probabilities summed, all
        of one sign. The JAX package's ``base + bits @ (lp_pos - lp_neg)``
        is the same sum, but at inv_temperature 100 its two terms run to
        hundreds and cancel to the small log-probabilities of the likely
        codes, which leaves ~1e-5 relative error in the entropy in
        float32."""
        a = 4.0 * self.inv_temperature * self.code_scale * z     # (N, c, d)
        lp = torch.cat([F.logsigmoid(a), F.logsigmoid(-a)], dim=-1)
        kc = min(self.codebook_size, self.entropy_chunk_size)
        mask = _bit_mask(self.codebook_dim, z.device)

        def chunk_entropy(lp, first: int):
            codes = first + torch.arange(kc, device=lp.device)
            bits = ((codes[:, None] & mask) != 0).float()
            logp = torch.einsum('ncd,kd->nck', lp,
                                torch.cat([bits, 1 - bits], dim=-1))
            m = global_row_mean(logp.exp())                               # (c, kc)
            return -torch.where(m > 1e-30,
                                m * torch.log(m.clamp(min=1e-30)),
                                0.0).sum(-1)

        h = torch.zeros(z.shape[1], device=z.device)
        for first in range(0, self.codebook_size, kc):
            h = h + checkpoint(chunk_entropy, lp, first, use_reentrant=False)
        return h.mean()

    def indices_to_codes(self, indices, dtype=torch.float32):
        """Inverse of the bit pack: indices ``(b, *spatial[, c])`` -> codes
        -> ``project_out``, in ``dtype``."""
        if not self.keep_cb_dim:
            indices = indices[..., None]
        bits = (indices[..., None] & _bit_mask(self.codebook_dim,
                                               indices.device)) != 0
        codes = torch.where(bits, 1.0, -1.0) * self.code_scale
        codes = codes.flatten(-2).to(dtype)
        if self.has_projections:
            codes = self.project_out(codes)
        return codes


class FSQ(nn.Module):
    """The JAX package's ``FSQ`` (arXiv 2309.15505; reference
    magvit2_pytorch.py:1378-1382): codebook size ``prod(levels)``."""

    def __init__(self, levels: Sequence[int], dim: Optional[int] = None,
                 num_codebooks: int = 1, eps: float = 1e-3,
                 keep_num_codebooks_dim: Optional[bool] = None):
        super().__init__()
        self.levels = tuple(int(l) for l in levels)
        self.codebook_dim = len(self.levels)
        self.num_codebooks = num_codebooks
        self.codebook_dims = self.codebook_dim * num_codebooks
        self.codebook_size = math.prod(self.levels)
        self.dim = default(dim, self.codebook_dims)
        self.eps = eps
        self.keep_cb_dim = default(keep_num_codebooks_dim, num_codebooks > 1)
        basis = [1]
        for l in self.levels[:-1]:
            basis.append(basis[-1] * l)
        self.basis = tuple(basis)
        self.has_projections = self.dim != self.codebook_dims
        if self.has_projections:
            self.project_in = Linear(self.dim, self.codebook_dims)
            self.project_out = Linear(self.codebook_dims, self.dim)

    def _levels(self, device):
        return torch.tensor(self.levels, dtype=torch.float32, device=device)

    def _half_width(self, device):
        return torch.floor_divide(self._levels(device), 2)

    def _bound(self, z):
        levels = self._levels(z.device)
        half_l = (levels - 1) * (1 + self.eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def bounded_values(self, x):
        """The bounded values before rounding, float32
        ``(..., num_codebooks, d)``; each one's distance to the nearest
        half-integer is its digit's decision margin."""
        if self.has_projections:
            x = self.project_in(x)
        z = x.float().unflatten(-1, (self.num_codebooks, self.codebook_dim))
        return self._bound(z)

    def forward(self, x, train: bool = False) -> QuantizerOutput:
        """x ``(b, *spatial, dim)``; the quantized tensor in x's dtype, int64
        indices ``(b, *spatial[, num_codebooks])`` and a zero aux loss (FSQ
        has none)."""
        bounded = self.bounded_values(x)
        # the straight-through round, in eval too, as the JAX package
        quantized = bounded + (torch.round(bounded) - bounded).detach()
        half_width = self._half_width(x.device)
        codes = quantized / half_width
        digits = (codes * half_width + half_width).to(torch.int32)
        basis = torch.tensor(self.basis, dtype=torch.int32, device=x.device)
        indices = (digits * basis).sum(-1).long()
        out = codes.flatten(-2).to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        if not self.keep_cb_dim:
            indices = indices.squeeze(-1)
        return QuantizerOutput(out, indices, torch.zeros((), device=x.device))

    def indices_to_codes(self, indices, dtype=torch.float32):
        if not self.keep_cb_dim:
            indices = indices[..., None]
        device = indices.device
        basis = torch.tensor(self.basis, device=device)
        levels = torch.tensor(self.levels, device=device)
        digits = (indices[..., None] // basis) % levels
        half_width = self._half_width(device)
        codes = (digits.float() - half_width) / half_width
        codes = codes.flatten(-2).to(dtype)
        if self.has_projections:
            codes = self.project_out(codes)
        return codes
