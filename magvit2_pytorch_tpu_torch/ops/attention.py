"""Attention modules on channels-last video (PyTorch counterpart of
``magvit2_pytorch_tpu/ops/attention.py``): full attention with learned memory
KV, its axial space/time wrappers, and Taylor-series linear attention.

``Attention`` has two paths, chosen by a static gate that does not look at
the device (``ops/kernels/axial_attention.py:fused_eligible``):

- the fused block: the module hands its parameters to one kernel wrapper
  (norm, qkv, memory-KV softmax attention, out projection; the CUDA kernel
  on the card, its plain version on the CPU);
- the general path, for rotary positions, attention dropout, a key-padding
  mask, conditioning, a stream, ``backend='flash'``, long sequences and head
  sizes the block kernel does not take: (Adaptive)RMSNorm, ``to_qkv``,
  optional rotary, the stream's kv-cache, then dropout with explicit
  probabilities, or ``attend_with_memory``, or the memory KV concatenated in
  front of k and v and ``attend`` (which reaches the flash kernels), then
  ``to_out``. The projections are plain PyTorch on the card too, as the JAX
  package leaves them to XLA.

``dim_cond``: the norm is an ``AdaptiveRMSNorm`` of the cond vector, which
the space and time wrappers repeat over frames and pixels. ``state`` (a
stream's dict keyed by module, ``models/streaming.py``): a causal module
keeps the keys and values of the stream so far and each chunk's queries
attend over them, the causal mask right-aligned, so chunked calls compute
what one whole-clip call does (``ops/attention.py:95-122`` of the JAX
package). Rotary positions count from the stream's start; ``kv_window``
keeps only that many past tokens (exact while it covers the stream).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.ops.attend import (
    attend, attend_with_memory, causal_hidden)
from magvit2_pytorch_tpu_torch.ops.basic import Linear
from magvit2_pytorch_tpu_torch.ops.kernels.axial_attention import (
    attention_block, fused_eligible, fused_time_eligible,
    time_attention_block)
from magvit2_pytorch_tpu_torch.ops.kernels.taylor_attention import (
    taylor_attention, taylor_attention_ref, taylor_eligible)
from magvit2_pytorch_tpu_torch.ops.norms import AdaptiveRMSNorm, RMSNorm
from magvit2_pytorch_tpu_torch.ops.rotary import (
    apply_rope, rope_angles, rope_angles_2d)
from magvit2_pytorch_tpu_torch.parallel.batch import rand_rows
from magvit2_pytorch_tpu_torch.utils.helpers import exists


class Attention(nn.Module):
    """Pre-norm multi-head attention with ``num_memory_kv`` learned key/values
    (reference magvit2_pytorch.py:327-388) on sequences ``(B, N, C)``.
    Parameters: ``norm.gamma`` (``norm.to_gamma.*`` with ``dim_cond``),
    ``to_qkv.0.weight``, ``mem_kv``, ``to_out.1.weight``.

    ``backend``: the ``attend`` backend of the general path (None = the
    default, ``'auto'``); ``'flash'`` also keeps the module off
    ``attend_with_memory``. ``use_rotary``: rotary positions on q and k.
    ``dropout``: attention-probability dropout, applied only when
    ``forward`` is given a ``torch.Generator``. ``kv_window``: the most
    past tokens a stream's cache keeps (None: all)."""

    def __init__(self, dim: int, dim_head: int = 32, heads: int = 8,
                 num_memory_kv: int = 4, causal: bool = False,
                 backend: Optional[str] = None, use_rotary: bool = False,
                 dropout: float = 0.0, dim_cond: Optional[int] = None,
                 kv_window: Optional[int] = None):
        super().__init__()
        assert num_memory_kv > 0
        dim_inner = dim_head * heads
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.causal, self.num_memory_kv = causal, num_memory_kv
        self.backend, self.use_rotary, self.dropout = (
            backend, use_rotary, dropout)
        self.kv_window = kv_window
        self.norm = (AdaptiveRMSNorm(dim, dim_cond) if exists(dim_cond)
                     else RMSNorm(dim))
        self.to_qkv = nn.Sequential(Linear(dim, dim_inner * 3, bias=False))
        self.mem_kv = nn.Parameter(
            torch.empty(2, heads, num_memory_kv, dim_head))
        self.to_out = nn.Sequential(nn.Identity(),
                                    Linear(dim_inner, dim, bias=False))

    def init_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.mem_kv.copy_(torch.randn(self.mem_kv.shape, generator=gen))

    def block_params(self):
        return (self.norm.gamma, self.to_qkv[0].weight, self.mem_kv,
                self.to_out[1].weight)

    def _gate_args(self, mask, state):
        return dict(dropout=self.dropout, use_rotary=self.use_rotary,
                    has_mask=exists(mask), has_cond=self.norm.conditioned,
                    streaming=state is not None)

    def forward(self, x, mask=None, cond=None, state: Optional[dict] = None,
                rope=None, generator=None):
        """x ``(B, N, C)``; mask ``(B, N)`` bool key padding (True = keep);
        cond ``(B, dim_cond)`` with ``dim_cond``; state: a stream's dict
        (causal modules only); rope ``(cos, sin)`` to use in place of the
        1D angles; generator: the dropout's random source (no generator, no
        dropout)."""
        if fused_eligible(x.shape[1], self.dim, self.heads, self.dim_head,
                          **self._gate_args(mask, state)):
            return attention_block(x, *self.block_params(), self.heads,
                                   self.dim_head, self.causal)
        return self._general(x, mask, cond, state, rope, generator)

    def _general(self, x, mask, cond, state, rope, generator):
        x = self.norm(x, cond)
        b, n, _ = x.shape
        heads, dim_head, num_mem = self.heads, self.dim_head, self.num_memory_kv
        # channel layout (qkv, heads, dim_head), qkv slowest; heads stay in
        # axis 2
        qkv = self.to_qkv(x).reshape(b, n, 3, heads, dim_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

        if state is not None:
            q, k, v = self._stream(q, k, v, mask, state)
        elif self.use_rotary:
            if rope is None:
                rope = rope_angles(torch.arange(n, device=x.device), dim_head)
            cos, sin = rope
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        mem_kv = self.mem_kv.to(x.dtype)

        def with_memory(k, v):
            """The memory KV in front of k and v: (b, num_mem + m, h, d)."""
            mem = mem_kv.transpose(1, 2)[:, None].expand(
                2, b, num_mem, heads, dim_head)
            return torch.cat((mem[0], k), dim=1), torch.cat((mem[1], v), dim=1)

        if self.dropout > 0 and exists(generator):
            # explicit probabilities, so the dropout applies to the
            # attention weights (reference Attend attn_dropout)
            kd, vd = with_memory(k, v)
            m_len = kd.shape[1]
            dots = torch.einsum('bihd,bjhd->bhij', q.float(), kd.float())
            dots = dots * (dim_head ** -0.5)
            if self.causal:
                dots = dots.masked_fill(causal_hidden(n, m_len, x.device),
                                        torch.finfo(torch.float32).min)
            probs = torch.softmax(dots, dim=-1)
            keep = rand_rows(probs.shape, generator,
                             probs.device) < 1.0 - self.dropout
            probs = torch.where(keep, probs / (1.0 - self.dropout), 0.0)
            out = torch.einsum('bhij,bjhd->bihd', probs.to(x.dtype), vd)
        elif not exists(mask) and self.backend != 'flash':
            # joint softmax over (sequence, memory) logits, no concat
            out = attend_with_memory(q, k, v, mem_kv[0], mem_kv[1],
                                     causal=self.causal)
        else:
            k, v = with_memory(k, v)
            if exists(mask):
                # key padding mask (b, n) -> (b, h, n, m); memory always
                # visible
                mask = torch.cat((mask.new_ones(b, num_mem), mask), dim=1)
                mask = mask[:, None, None, :].expand(b, heads, n,
                                                     mask.shape[-1])
            out = attend(q, k, v, causal=self.causal, mask=mask,
                         backend=self.backend, layout='bnhd')

        return self.to_out(out.reshape(b, n, heads * dim_head))

    def _stream(self, q, k, v, mask, state):
        """The causal kv-cache of a stream: this chunk's keys and values go
        behind the cached ones (cut to ``kv_window``); with rotary, q and k
        rotate by their place in the stream, not in the cache."""
        if not self.causal or exists(mask):
            raise ValueError('a stream runs causal attention without a mask')
        cache = state.get(self)
        if self.use_rotary:
            pos = 0 if cache is None else cache['pos']
            n = q.shape[1]
            cos, sin = rope_angles(
                torch.arange(pos, pos + n, device=q.device), self.dim_head)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if cache is not None:
            k = torch.cat((cache['k'], k), dim=1)
            v = torch.cat((cache['v'], v), dim=1)
        keep = k.shape[1] if self.kv_window is None else self.kv_window
        ck, cv = k[:, -keep:], v[:, -keep:]
        if cache is None or ck.shape[1] < k.shape[1]:
            # a view of qkv, or of a longer cat: copied, so the cache holds
            # no more than it keeps
            ck, cv = ck.clone(), cv.clone()
        state[self] = dict(k=ck, v=cv, pos=(0 if cache is None else
                                            cache['pos']) + q.shape[1])
        return q, k, v


def repeat_cond(cond, groups: int):
    """A per-sample cond ``(B, D)`` for ``B * groups`` sequences, each
    sample's rows together (``jnp.repeat`` along axis 0)."""
    return None if cond is None else cond.repeat_interleave(groups, dim=0)


class SpaceAttention(Attention):
    """Attention over the h*w pixels of each frame (reference
    magvit2_pytorch.py:444-454), on video ``(B, T, H, W, C)`` or images
    ``(B, H, W, C)``. With ``use_rotary`` the positions are axial 2D RoPE
    over (row, column). ``mask``: ``(B*T, H*W)`` key padding. Frames are
    independent, so a stream needs no state here: the module takes none,
    as the JAX package's does not, and a streamed chunk takes the block
    kernel where a whole clip does."""

    def forward(self, x, mask=None, cond=None, generator=None):
        *lead, h, w, c = x.shape
        rope = None
        if self.use_rotary:
            rope = rope_angles_2d(h, w, self.dim_head, device=x.device)
        seq = x.reshape(-1, h * w, c)
        cond = repeat_cond(cond, seq.shape[0] // x.shape[0])
        out = super().forward(seq, mask=mask, cond=cond, rope=rope,
                              generator=generator)
        return out.reshape(*lead, h, w, c)


class TimeAttention(Attention):
    """Attention over t for each pixel, causal in the layer stack (reference
    magvit2_pytorch.py:456-464). The fused block runs on the
    ``(B, T, H*W, C)`` view with no transpose; the general path on the
    ``(B*H*W, T, C)`` sequences. ``mask``: ``(B*H*W, T)`` key padding."""

    def __init__(self, *args, causal: bool = True, **kwargs):
        super().__init__(*args, causal=causal, **kwargs)

    def forward(self, x, mask=None, cond=None, state: Optional[dict] = None,
                generator=None):
        b, t, h, w, c = x.shape
        if fused_time_eligible(t, h * w, self.dim, self.heads, self.dim_head,
                               **self._gate_args(mask, state)):
            out = time_attention_block(x.reshape(b, t, h * w, c),
                                       *self.block_params(), self.heads,
                                       self.dim_head, self.causal)
            return out.reshape(b, t, h, w, c)
        seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        out = super().forward(seq, mask=mask,
                              cond=repeat_cond(cond, h * w), state=state,
                              generator=generator)
        return out.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


class TaylorSeriesLinearAttn(nn.Module):
    """Second-order Taylor-softmax linear attention (the external
    ``taylor_series_linear_attention`` package the reference wraps,
    magvit2_pytorch.py:34,415-419). Parameters ``to_qkv.0.weight`` and
    ``to_out.1.weight``, no biases."""

    def __init__(self, dim: int, dim_head: int = 8, heads: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        dim_inner = dim_head * heads
        self.heads, self.dim_head, self.eps = heads, dim_head, eps
        self.to_qkv = nn.Sequential(Linear(dim, dim_inner * 3, bias=False))
        self.to_out = nn.Sequential(nn.Identity(),
                                    Linear(dim_inner, dim, bias=False))

    def forward(self, x, gamma=None):
        """x ``(B, N, C)``; ``gamma`` folds the preceding RMSNorm into the
        block (``attention.py:224-228``); None: x is normed already (the
        block's no-norm route, which a conditioned norm takes)."""
        # a head size the kernel does not take runs the plain version on
        # every device, as the JAX package takes its XLA reference
        block = (taylor_attention if taylor_eligible(self.dim_head)
                 else taylor_attention_ref)
        return block(x, gamma, self.to_qkv[0].weight, self.to_out[1].weight,
                     self.heads, self.dim_head, self.eps)


class LinearAttention(nn.Module):
    """(Adaptive)RMSNorm pre-norm around TaylorSeriesLinearAttn (reference
    magvit2_pytorch.py:390-430): a plain norm's gamma goes to the kernel; a
    conditioned norm runs first and the block takes its no-norm route
    (``ops/attention.py:250-252`` of the JAX package)."""

    def __init__(self, dim: int, dim_head: int = 8, heads: int = 8,
                 dim_cond: Optional[int] = None):
        super().__init__()
        self.norm = (AdaptiveRMSNorm(dim, dim_cond) if exists(dim_cond)
                     else RMSNorm(dim))
        self.attn = TaylorSeriesLinearAttn(dim, dim_head=dim_head, heads=heads)

    def forward(self, x, cond=None):
        if self.norm.conditioned:
            return self.attn(self.norm(x, cond))
        return self.attn(x, gamma=self.norm.gamma)


class LinearSpaceAttention(LinearAttention):
    """Linear attention over the h*w pixels of each frame (reference
    magvit2_pytorch.py:432-442)."""

    def forward(self, x, cond=None):
        *lead, h, w, c = x.shape
        seq = x.reshape(-1, h * w, c)
        out = super().forward(seq, repeat_cond(cond,
                                               seq.shape[0] // x.shape[0]))
        return out.reshape(*lead, h, w, c)
