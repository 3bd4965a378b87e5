"""The terms of a step that read the whole batch, when each rank holds only
its rows of it.

A data-parallel step must give what the one-process step gives on the
global batch, as the JAX package's SPMD step does: a mean of per-row values
is then the mean of the ranks' means, and its gradient the mean of their
gradients, which the trainer's all-reduce takes. Other uses of the batch are
made global here while :func:`sharded_batch` is active:

- :func:`global_row_mean`, the LFQ codebook entropy's mean distribution and
  the bit rates of the entropy canary: the rows summed over the ranks
  through a differentiable all-reduce, whose backward all-reduces the
  gradient, so the ranks' averaged gradient is the global mean's;
- :func:`global_mean`, the adaptive adversarial weight's gradient norms:
  the gradient of the global mean loss, averaged before the norm;
- :func:`rand_rows`, attention dropout: the mask drawn for the global batch
  and cut to this rank's rows (the frame picks are drawn and cut by the
  trainer).

Outside the context every function is its one-process form.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's place in a global batch: the group of the batch axes,
    its index among the ``count`` shards of equal size."""
    group: object
    index: int
    count: int


_SHARD: list = [None]


@contextlib.contextmanager
def sharded_batch(shard: Optional[BatchShard]):
    """Run the body with the batch's rows cut as ``shard`` says (None: the
    whole batch is here)."""
    prev, _SHARD[0] = _SHARD[0], shard
    try:
        yield
    finally:
        _SHARD[0] = prev


def current_shard() -> Optional[BatchShard]:
    return _SHARD[0]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the gradients over it: each
    rank's gradient then carries every rank's use of the sum, and the
    ranks' averaged gradient is the gradient of the global term."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_row_mean(x):
    """``x.mean(0)`` over the rows of the global batch."""
    shard = current_shard()
    if shard is None:
        return x.mean(0)
    s = x.sum(0)
    packed = torch.cat([s.reshape(-1), s.new_full((1,), x.shape[0])])
    packed = _AllReduceSum.apply(packed, shard.group)
    return (packed[:-1] / packed[-1]).reshape(s.shape)


@torch.no_grad()
def global_mean(t):
    """The mean of ``t`` over the shards (no gradient)."""
    shard = current_shard()
    if shard is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=shard.group)
    return t / shard.count


def rand_rows(shape, generator, device):
    """``torch.rand(shape)`` whose leading dim is batch-major rows: drawn
    for the global batch and cut to this rank's rows."""
    shard = current_shard()
    if shard is None:
        return torch.rand(shape, generator=generator, device=device)
    rows = shape[0]
    full = torch.rand((rows * shard.count, *shape[1:]), generator=generator,
                      device=device)
    return full[shard.index * rows:(shard.index + 1) * rows]
