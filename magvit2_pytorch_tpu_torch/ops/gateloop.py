"""GateLoop: a data-dependent gated linear recurrence over time (PyTorch
counterpart of ``magvit2_pytorch_tpu/ops/gateloop.py``; the reference plugs
in ``gateloop_transformer.SimpleGateLoopLayer`` for ``'gateloop_time'``,
magvit2_pytorch.py:32,1216-1222). Per channel,

    s_t = a_t * s_{t-1} + k_t * v_t,    o_t = q_t * s_t,

with ``a = sigmoid(.)`` and the state in float32. The JAX package takes an
associative scan; here a plain loop over t does the same sums one frame at
a time. A chunk that starts from the previous chunk's last state so runs
exactly the operations of the whole clip, so a stream gives the whole
clip's output to the bit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import Linear, filter_kwargs


def gated_linear_recurrence(a, x, initial_state=None):
    """``s_t = a_t * s_{t-1} + x_t`` along axis 1 of ``a``, ``x`` ``(B, T,
    D)``, from ``initial_state`` ``(B, D)`` (zeros when None). Returns ``s``
    ``(B, T, D)`` in the inputs' dtype."""
    s = (torch.zeros_like(x[:, 0]) if initial_state is None
         else initial_state.to(x.dtype))
    out = []
    for t in range(x.shape[1]):
        s = a[:, t] * s + x[:, t]
        out.append(s)
    return torch.stack(out, dim=1)


class SimpleGateLoopLayer(nn.Module):
    """``(B, N, C) -> (B, N, C)`` with per-channel data-dependent forget
    gates: ``to_qkva`` ``(4 C, C)`` split into q, k, v and the gate logits
    a, then ``to_out``; neither has a bias. ``state`` (a stream's dict
    keyed by module): the recurrence starts from the previous chunk's last
    state."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_qkva = Linear(dim, dim * 4, bias=False)
        self.to_out = Linear(dim, dim, bias=False)

    def forward(self, x, state: Optional[dict] = None):
        q, k, v, a = self.to_qkva(x).chunk(4, dim=-1)
        a = torch.sigmoid(a.float())
        kv = (k * v).float()
        s = gated_linear_recurrence(
            a, kv, None if state is None else state.get(self))
        if state is not None:
            state[self] = s[:, -1].clone()
        return self.to_out((q.float() * s).to(x.dtype))


class ToTimeSequence(nn.Module):
    """``fn`` over the time axis of each pixel: ``(B, T, H, W, C)`` ->
    ``fn`` on ``(B*H*W, T, C)`` -> back (reference ToTimeSequence,
    magvit2_pytorch.py:178-191). The kwargs ``fn`` takes go on to it."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kwargs):
        b, t, h, w, c = x.shape
        seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        out = self.fn(seq, **filter_kwargs(self.fn, kwargs))
        return out.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)
