"""The optimizer (PyTorch counterpart of
``magvit2_pytorch_tpu/training/optimizer.py``, reference optimizer.py:12-42):
Adam at ``wd=0``, else AdamW with decoupled decay, behind a global-norm clip
and a non-finite skip, with optax's semantics, which the trainer's numbers
depend on:

- the chain is ``apply_if_finite(chain(clip_by_global_norm, adam(w)))``: a
  step whose gradients hold a NaN or inf is skipped (parameters, moments
  and counts unchanged) unless it is the 11th in a row
  (``max_consecutive_errors=10``), which is applied;
- the clip scales by ``max_norm / ||g||`` when ``||g|| >= max_norm``,
  ``||g||`` the norm over every gradient, with no epsilon (torch's
  ``clip_grad_norm_`` adds 1e-6);
- Adam's moments are ``(1 - b) g + b m``, bias-corrected by the count of
  applied updates; the update is ``m_hat / (sqrt(v_hat) + eps)``, plus
  ``wd * p`` where the weight-decay mask holds, times ``-lr``;
- the learning rate at the n-th applied update (from 0) is the warmup's
  ``optax.linear_schedule(lr / warmup, lr, warmup)`` at n, or a
  ``scheduler(n)``;
- the weight-decay mask is the JAX package's ``p.ndim >= 2`` on the JAX
  shapes (``wd_mask``), read through the bridge's name map.

The state is float32 moments per parameter name and the counts; the
parameters are updated in place under ``torch.no_grad()``, which bumps
their version counters (the fused ResidualUnit's weight re-lay cache keys
on them).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from magvit2_pytorch_tpu_torch.models.jax_import import TRANSFORMS


def wd_mask(named_params: Mapping, entries=()) -> Dict[str, bool]:
    """Which parameters take weight decay: those whose JAX counterpart has
    two or more axes (the JAX package's ``wd_mask``). ``entries`` (the
    bridge's ``(port key, JAX path, transform)`` rows) give the JAX shape;
    a parameter without a row keeps its own rank."""
    kinds = {key: kind for key, _, kind in entries}
    out = {}
    for name, p in named_params.items():
        ndim = p.ndim
        if name in kinds:
            view = np.broadcast_to(np.float32(0), tuple(p.shape))
            ndim = np.ndim(TRANSFORMS[kinds[name]][1](view))
        out[name] = ndim >= 2
    return out


def linear_warmup(lr: float, warmup_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule(lr / warmup_steps, lr, warmup_steps)``."""
    init = lr / warmup_steps

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
        return float(np.float32(init - lr) * np.float32(frac)
                     + np.float32(lr))
    return schedule


class Optimizer:
    """``get_optimizer``'s chain over a dict of named parameters."""

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float = 1e-4,
                 wd: float = 1e-2, betas=(0.9, 0.99), eps: float = 1e-8,
                 mask: Optional[Mapping[str, bool]] = None,
                 warmup_steps: int = 0,
                 max_grad_norm: Optional[float] = None,
                 scheduler: Optional[Callable[[int], float]] = None,
                 skip_nonfinite_updates: bool = True,
                 max_consecutive_errors: int = 10):
        self.params = dict(params)
        self.betas, self.eps, self.wd = betas, eps, wd
        self.mask = dict(mask) if mask is not None else {
            n: p.ndim >= 2 for n, p in self.params.items()}
        if scheduler is not None:
            self.schedule = scheduler
        elif warmup_steps > 1:
            self.schedule = linear_warmup(lr, warmup_steps)
        else:
            self.schedule = lambda count: lr
        self.max_grad_norm = max_grad_norm
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.max_consecutive_errors = max_consecutive_errors
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self.count = 0              # applied updates (Adam's and the lr's)
        self.notfinite_count = 0    # non-finite steps in a row
        self.total_notfinite = 0
        self.shard_group, self.sharded = None, frozenset()

    def shard(self, group, names):
        """The parameters ``names`` hold this rank's part of a parameter cut
        over ``group`` (tensor parallelism): the non-finite check and the
        clip's norm then read every rank's part."""
        self.shard_group, self.sharded = group, frozenset(names)

    def _finite(self, g) -> bool:
        finite = torch.stack([x.isfinite().all() for x in g]).all()
        if self.shard_group is not None:
            finite = finite.to(torch.uint8)
            torch.distributed.all_reduce(
                finite, op=torch.distributed.ReduceOp.MIN,
                group=self.shard_group)
        return bool(finite)

    def _norm(self, names, g):
        if self.shard_group is None:
            return torch.sqrt(sum((x * x).sum() for x in g))
        zero = torch.zeros((), device=g[0].device)
        cut = sum(((x * x).sum() for n, x in zip(names, g)
                   if n in self.sharded), zero)
        whole = sum(((x * x).sum() for n, x in zip(names, g)
                     if n not in self.sharded), zero)
        torch.distributed.all_reduce(cut, group=self.shard_group)
        return torch.sqrt(whole + cut)

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """Apply one update from ``grads`` (by name, any float dtype);
        returns whether it was applied."""
        names = list(self.params)
        g = [grads[n].float() for n in names]
        if self.skip_nonfinite_updates:
            finite = self._finite(g)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not (finite
                    or self.notfinite_count > self.max_consecutive_errors):
                return False
        if self.max_grad_norm is not None:
            norm = self._norm(names, g)
            keep = norm < self.max_grad_norm
            g = [torch.where(keep, x, x / norm * self.max_grad_norm)
                 for x in g]
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.betas
        c1 = float(np.float32(1) - np.float32(b1) ** self.count)
        c2 = float(np.float32(1) - np.float32(b2) ** self.count)
        for n, x in zip(names, g):
            mu, nu, p = self.mu[n], self.nu[n], self.params[n]
            mu.copy_((1 - b1) * x + b1 * mu)
            nu.copy_((1 - b2) * (x * x) + b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd and self.mask[n]:
                update = update + self.wd * p.float()
            p.copy_((p.float() + (-lr) * update).to(p.dtype))
        return True

    @torch.no_grad()
    def load_moments(self, mu: Mapping, nu: Mapping, count: int):
        """Adam's moments by parameter name and the count of applied
        updates (which keys the learning-rate schedule), as a reference
        optimizer's state gives them; the non-finite counters stay."""
        for n in self.params:
            self.mu[n].copy_(mu[n])
            self.nu[n].copy_(nu[n])
        self.count = int(count)

    def state_dict(self) -> dict:
        return {'mu': self.mu, 'nu': self.nu, 'count': self.count,
                'notfinite_count': self.notfinite_count,
                'total_notfinite': self.total_notfinite}

    def load_state_dict(self, state: Mapping):
        for key in ('mu', 'nu'):
            for n, t in getattr(self, key).items():
                t.copy_(state[key][n])
        self.count = int(state['count'])
        self.notfinite_count = int(state['notfinite_count'])
        self.total_notfinite = int(state['total_notfinite'])


def get_optimizer(params: Mapping[str, torch.Tensor], lr: float = 1e-4,
                  wd: float = 1e-2, betas=(0.9, 0.99), eps: float = 1e-8,
                  group_wd_params: bool = True, warmup_steps: int = 0,
                  max_grad_norm: Optional[float] = None, scheduler=None,
                  skip_nonfinite_updates: bool = True,
                  mask: Optional[Mapping[str, bool]] = None) -> Optimizer:
    """The JAX package's ``get_optimizer`` (its arguments, in its order,
    after the parameters): ``group_wd_params`` decays only where ``mask``
    (default :func:`wd_mask` without a bridge) holds; ``wd=0`` is Adam."""
    if group_wd_params:
        mask = dict(mask) if mask is not None else wd_mask(params)
    else:
        mask = {n: True for n in params}
    return Optimizer(params, lr=lr, wd=wd, betas=betas, eps=eps, mask=mask,
                     warmup_steps=warmup_steps, max_grad_norm=max_grad_norm,
                     scheduler=scheduler,
                     skip_nonfinite_updates=skip_nonfinite_updates)
